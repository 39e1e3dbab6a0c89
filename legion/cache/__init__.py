from legion.cache.hotness import presample_hotness  # noqa: F401
from legion.cache.cost_model import CachePlanResult, solve_cost_model  # noqa: F401
from legion.cache.feature_cache import FeatureCache  # noqa: F401
from legion.cache.topo_cache import TopoCache  # noqa: F401
