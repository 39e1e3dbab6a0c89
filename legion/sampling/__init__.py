from legion.sampling.block import Block, SampledBatch, frontier_caps  # noqa: F401
from legion.sampling.sampler import DeviceGraph, sample_batch, sample_neighbors  # noqa: F401
from legion.sampling.seeds import SeedPlan, make_seed_plan  # noqa: F401
