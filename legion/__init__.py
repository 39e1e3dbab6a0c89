"""legion — a JAX mini-batch GNN training framework.

A from-scratch JAX/XLA/Pallas/pjit redesign of the capabilities of Legion
(USENIX ATC'23): on-device neighbor sampling,
hotness-aware hierarchical feature/topology caching driven by a presampling
cost model, and sparse neighborhood aggregation — as XLA programs:

* sampling, dedup/renumbering, feature gather and aggregation are jitted
  functions with static padded shapes (replacing CUDA kernels + atomics,
  reference ``src/Kernels.cu``);
* the sampler/trainer pipeline is in-process double-buffered prefetch
  (replacing the CUDA-IPC server/client split, ``src/CUDA_IPC_Service.cu``);
* the hotness cache is a sorted-hot-id feature cache + compacted sub-CSR
  in HBM (replacing BGHT hash tables + NVLink clique caches,
  ``src/GPUCache.cu``);
* scaling is data-parallel ``shard_map`` over a device mesh with the cache
  striped over a cache mesh axis (replacing NCCL DDP + P2P pointer tables).
"""

__version__ = "0.1.0"

from legion.config import (  # noqa: F401
    CacheConfig,
    Config,
    DatasetConfig,
    ModelConfig,
    ParallelConfig,
    SamplerConfig,
    TrainConfig,
)
