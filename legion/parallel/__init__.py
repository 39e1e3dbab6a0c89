from legion.parallel.mesh import make_mesh  # noqa: F401
from legion.parallel.feature_exchange import (  # noqa: F401
    shard_rows, sharded_row_fetch)
from legion.parallel.dp import make_dp_train_step  # noqa: F401
