"""Device-mesh construction.

The reference's device topology is fixed at 8 GPUs in Kc NVLink cliques
of Kg GPUs (``src/GPUCache.cu:590-612``); runners are 1:1 with GPUs and
DDP spans all of them. Here the topology is a ``jax.sharding.Mesh`` with
two axes:

* ``data``  — data parallelism (the reference's per-GPU runners + DDP);
* ``cache`` — the cache group: chips that jointly hold one striped copy
  of the hot feature/topology cache (the Kg NVLink clique; on one host
  every card reaches every other over NVLink at the same rate, so the
  mesh follows the algorithm only).

Total chips = data x cache. group_size=1 degenerates to replicated
caches (cache_agg_mode 0); group_size=all-chips is the NVSwitch-like
Kg=8 mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(num_devices: int = 0, cache_group_size: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if num_devices:
        devs = devs[:num_devices]
    n = len(devs)
    assert n % cache_group_size == 0, (
        f"{n} devices not divisible by cache group {cache_group_size}")
    arr = np.array(devs).reshape(n // cache_group_size, cache_group_size)
    return Mesh(arr, ("data", "cache"))
