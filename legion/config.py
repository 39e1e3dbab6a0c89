"""Single-source-of-truth configuration.

The reference splits configuration across argparse, a space-separated
``meta_config`` file, binary argv, and compile-time constants (several of
which silently disagree — e.g. the Python ``--nbrs_num`` flag is ignored by
the C++ server which hardcodes fanout [25,10] at ``src/Server.cu:68-69``).
Here there is exactly one dataclass tree; everything derives from it.

Reference config surface being replaced:
* ``legion_server.py:74-84``  (argparse + dataset registry)
* ``src/GPUGraphStore.cu:190-252`` (ReadMetaFIle)
* compile-time constants ``PIPELINE_DEPTH`` (src/Server.cu:15),
  ``MAX_DEVICE`` (src/CUDA_IPC_Service.cu:16), valid/test batch 512
  (src/CUDA_IPC_Service.cu:98,111), cost-model granularity
  ``MIN_INTERVAL 0.01`` / payload ``CLS 64`` (src/GPUCache.cu:30-31).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Where the graph lives and its shape.

    Mirrors the per-dataset entries of the reference registry
    (``legion_server.py:6-53``): path, node/edge counts, feature length,
    class count and the train/valid/test set sizes.
    """

    name: str = "synthetic"
    path: Optional[str] = None          # directory with packed binary files
    num_nodes: int = 0
    num_edges: int = 0
    feature_dim: int = 0
    num_classes: int = 0
    # Where features live: "hbm" (whole table on each chip),
    # "hbm_sharded" (row-sharded across the mesh), "host" (host RAM,
    # gathered by the C++ runtime / cache subsystem).
    feature_placement: str = "hbm"
    # Where topology lives: "hbm" or "host" (host CSR + HBM hot sub-CSR).
    topology_placement: str = "hbm"
    # Zero-pad the feature dim to this column multiple before device
    # placement (0 = off); 128 f32 columns = 512B rows. Inert for
    # numerics.
    feature_pad_align: int = 128


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Neighbor-sampling shape. fanouts[0] is sampled from the seed batch
    (used by the model's LAST layer), fanouts[k] from the hop-k frontier —
    the reference's op order (``src/Server.cu:198-207`` with fanout
    [25,10], hop1=25 from seeds)."""

    fanouts: Sequence[int] = (25, 10)
    batch_size: int = 1024
    eval_batch_size: int = 512          # src/CUDA_IPC_Service.cu:98,111
    # Padding-cap slack multiplier over observed frontier sizes; the
    # reference sizes feature buffers at 1.2 x observed MaxIdNum
    # (src/Server.cu:273-282). None => use the loose combinatorial bound.
    observed_cap_slack: float = 1.2
    # Probe realized frontier sizes at Trainer init (a few throwaway
    # batches at loose caps) and tighten the static caps before the main
    # compile. Skipped when the loose bound is below probe_caps_min_cap
    # (tiny graphs/batches: not worth the extra compile).
    probe_caps: bool = True
    probe_caps_min_cap: int = 262144
    probe_caps_batches: int = 3
    # Dedup the FINAL hop's frontier. False (default) is the fast path
    # for HBM features: the last hop is identity-appended
    # (sampler.append_frontier) — dedup sorts cost more than the
    # duplicate HBM feature gathers they save. Set True when features are host-resident/cached, where each
    # duplicate row costs host<->device bytes (the reference's PCIe-saving
    # rationale for dedup, src/Kernels.cu:412-421). Requires
    # caps[-1] == caps[-2]*(1+fanouts[-1]) exactly (frontier_caps yields
    # this; only intermediate caps may be tightened from observation).
    dedup_last: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Matches the reference model hyperparameters
    (``pytorch_extension/legion_graphsage.py:195-203``)."""

    arch: str = "sage"                  # sage | gcn | lp_sage
    hidden_dim: int = 256
    num_layers: int = 2
    dropout: float = 0.5
    # Compute dtype for dense layers; params stay float32.
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.003
    epochs: int = 10
    seed: int = 0
    # Depth of the sample->train prefetch pipeline (reference
    # PIPELINE_DEPTH 2, src/Server.cu:15).
    pipeline_depth: int = 2
    checkpoint_dir: Optional[str] = None
    # >0: the cached/striped trainers also save mid-epoch every N steps
    # (epoch-end saves always happen when checkpoint_dir is set) — the
    # crash-resilience knob for the longest runs.
    checkpoint_every_steps: int = 0
    # When set, epoch 0 is captured with the JAX profiler into this
    # directory (read it with jax.profiler.ProfileData or tensorboard).
    # The framework's tracing hook (SURVEY.md §5).
    profile_dir: Optional[str] = None
    # lax.scan unroll factor for whole-epoch programs: XLA schedules
    # across step boundaries inside an unrolled group, so step i+1's
    # sampling can overlap step i's gather/backward (the single-program
    # analog of the reference's two-stream overlap,
    # src/Server.cu:310-316). LEGION_SCAN_UNROLL env var overrides (A/B
    # convenience only; the config is the source of truth).
    scan_unroll: int = 4


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Hotness-aware hierarchical cache (reference ``src/GPUCache.cu``).

    ``budget_bytes`` is the per-chip HBM budget split between the feature
    cache and the topology cache by the cost model
    (``src/GPUCache.cu:661-767``). ``group_size`` is the number of chips
    that jointly hold one cache copy (the NVLink-clique ``Kg``)."""

    enabled: bool = False
    budget_bytes: int = 4 << 30
    group_size: int = 1                 # Kg analog; 1 = replicated cache
    cost_model_granularity: float = 0.01  # MIN_INTERVAL, src/GPUCache.cu:30
    presample_steps: int = 0            # 0 = one full epoch


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout: a (data x cache) mesh of ``num_devices``
    chips with cache groups of ``CacheConfig.group_size`` along the
    ``cache`` axis. Reference analog: per-GPU DP runners x NVLink
    cliques (Kc x Kg, ``src/GPUCache.cu:590-612``). Consumed by
    parallel.mesh.make_mesh via parallel.trainer.MeshTrainer and
    train.striped_driver."""

    num_devices: int = 0                # 0 = all local devices
    # Halo (boundary) exchange strategy for edge-partitioned training:
    # "exact" = per-ring-distance ppermute rounds with probed
    # non-uniform caps (each requested row crosses the network once;
    # over-cap requests are dropped LOUDLY and metered as
    # halo_overflow); "psum" = the cap-free all_gather + psum_scatter
    # oracle (K x the requested bytes). See parallel/halo.py.
    halo_exchange: str = "exact"
    # Slack over the observed per-distance request maxima when sizing
    # the exact exchange's caps (halo counts concentrate less tightly
    # than the striped cache's round-robin ranks, hence > 1.05).
    halo_cap_slack: float = 1.3
    halo_probe_batches: int = 2


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    # keys that existed in older config versions and were removed —
    # the ONLY unknown keys from_json tolerates; anything else (e.g. a
    # typo like "learning_rat") raises rather than silently training
    # with defaults.
    _REMOVED_KEYS = {"drop_last", "payload_bytes", "data_axis",
                     "donate_state", "log_every_steps"}

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)

        def mk(cls, sub):
            names = {f.name for f in dataclasses.fields(cls)}
            unknown = set(sub) - names - Config._REMOVED_KEYS
            if unknown:
                raise ValueError(
                    f"unknown {cls.__name__} key(s) {sorted(unknown)}; "
                    f"valid keys: {sorted(names)}")
            return cls(**{k: v for k, v in sub.items() if k in names})

        sampler = dict(d.get("sampler", {}))
        if "fanouts" in sampler:
            sampler["fanouts"] = tuple(sampler["fanouts"])
        return Config(
            dataset=mk(DatasetConfig, d.get("dataset", {})),
            sampler=mk(SamplerConfig, sampler),
            model=mk(ModelConfig, d.get("model", {})),
            train=mk(TrainConfig, d.get("train", {})),
            cache=mk(CacheConfig, d.get("cache", {})),
            parallel=mk(ParallelConfig, d.get("parallel", {})),
        )


# ---------------------------------------------------------------------------
# Known-dataset registry, mirroring legion_server.py:6-53 (codes PR/PA/CO/
# UKS/UKL/CL). Paths are left None: datasets are materialized locally by
# legion.data.ogb or synthesized by legion.data.synthetic.
# ---------------------------------------------------------------------------

DATASET_REGISTRY = {
    "PR": DatasetConfig(name="ogbn-products", num_nodes=2_449_029,
                        num_edges=123_718_280, feature_dim=100, num_classes=47),
    "PA": DatasetConfig(name="ogbn-papers100M", num_nodes=111_059_956,
                        num_edges=1_615_685_872, feature_dim=128, num_classes=172,
                        feature_placement="host", topology_placement="hbm"),
    "CO": DatasetConfig(name="com-friendster", num_nodes=65_608_366,
                        num_edges=1_806_067_135, feature_dim=256, num_classes=100,
                        feature_placement="host", topology_placement="hbm"),
    "UKS": DatasetConfig(name="uk-union", num_nodes=133_633_040,
                         num_edges=5_507_679_822, feature_dim=256, num_classes=100,
                         feature_placement="host", topology_placement="host"),
    "UKL": DatasetConfig(name="uk2014", num_nodes=787_801_471,
                         num_edges=47_284_178_505, feature_dim=128, num_classes=100,
                         feature_placement="host", topology_placement="host"),
    "CL": DatasetConfig(name="clueweb", num_nodes=955_207_488,
                        num_edges=42_574_107_469, feature_dim=128, num_classes=100,
                        feature_placement="host", topology_placement="host"),
    "AX": DatasetConfig(name="ogbn-arxiv", num_nodes=169_343,
                        num_edges=1_166_243, feature_dim=128, num_classes=40),
}
