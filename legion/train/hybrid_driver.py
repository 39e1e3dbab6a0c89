"""Hybrid-placement training driver: host CSR + HBM hot sub-CSR + host
features behind a FeatureCache.

The uk2014/clueweb-class placement (``topology_placement="host"``,
SURVEY.md placement matrix): topology exceeds device HBM, so the device
samples only cache-HIT frontier nodes from the compacted sub-CSR
(cache.topo_cache) while misses are sampled by the threaded C++ host
sampler and merged — the explicit analog of the reference's GPU threads
reading the pinned-host zero-copy CSR (``src/Kernels.cu:468-564``).
Features are host-resident behind the hotness feature cache exactly as
in the cached driver.

Presampling runs entirely on the host (the reference's pre-sampler also
reads the host CSR, ``kernel_pre_sampler_optimized``): hotness
histograms via the C++ runtime, realized frontier maxima for cap
sizing.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.cost_model import solve_cost_model
from legion.cache.feature_cache import FeatureCache, cache_dtype_for
from legion.cache.hotness import observed_caps, staging_rows
from legion.cache.hybrid import HybridSampler, HybridTrainer
from legion.cache.topo_cache import TopoCache
from legion.config import Config
from legion.data.format import GraphData
from legion.models import build_model
from legion.sampling.seeds import (
    epoch_eval_seeds, epoch_train_seeds, make_seed_plan, shard_node_set)
from legion.train.train_state import (
    create_train_state, restore_checkpoint, save_checkpoint)


def presample_hotness_host(indptr: np.ndarray, indices: np.ndarray,
                           seeds_epoch: np.ndarray,
                           fanouts: Sequence[int], num_nodes: int,
                           seed: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Host presampling epoch: per-node feature/topology hotness
    histograms + realized per-level frontier maxima. Mirrors
    cache.hotness.presample_hotness's semantics on the host CSR."""
    from legion import runtime
    node_hot = np.zeros(num_nodes, np.int64)
    edge_hot = np.zeros(num_nodes, np.int64)
    max_per_hop = np.zeros(len(fanouts) + 1, np.int64)
    for t in range(seeds_epoch.shape[0]):
        row = seeds_epoch[t]
        frontier = np.unique(row[row >= 0]).astype(np.int32)
        counts = [len(frontier)]
        for k, f in enumerate(fanouts):
            runtime.accumulate_hist(edge_hot, frontier)  # rows read
            nbrs = runtime.sample_neighbors(
                indptr, indices, frontier, f,
                seed=seed * 1_000_003 + t * 31 + k)
            new = nbrs[nbrs >= 0]
            frontier = np.unique(np.concatenate([frontier, new])
                                 ).astype(np.int32)
            counts.append(len(frontier))
        runtime.accumulate_hist(node_hot, frontier)      # rows gathered
        max_per_hop = np.maximum(max_per_hop, counts)
    return node_hot, edge_hot, max_per_hop


def run_hybrid_training(cfg: Config, data: GraphData, log=print) -> Dict:
    """Initialize -> PreSc(host) -> Run for the host-topology placement."""
    indptr = np.ascontiguousarray(np.asarray(data.indptr), np.int64)
    indices = np.ascontiguousarray(np.asarray(data.indices), np.int32)
    num_classes = cfg.dataset.num_classes or data.num_classes
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)

    shards = shard_node_set(np.asarray(data.train_ids), 1)
    plan = make_seed_plan([len(shards[0])], [max(len(data.valid_ids), 1)],
                          [max(len(data.test_ids), 1)], b,
                          cfg.sampler.eval_batch_size)
    rng = np.random.default_rng(cfg.train.seed)
    seeds, _ = epoch_train_seeds(rng, shards, plan)

    # ---- presampling (host CSR) --------------------------------------------
    t0 = time.perf_counter()
    steps = cfg.cache.presample_steps or plan.train_steps
    node_hot, edge_hot, max_per_hop = presample_hotness_host(
        indptr, indices, seeds[0][:steps], fanouts, data.num_nodes,
        cfg.train.seed)
    log(f"host presampling: {steps} steps in {time.perf_counter()-t0:.1f}s")

    # ---- cost model: split budget between feature + topo caches ------------
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    cost = solve_cost_model(node_hot, edge_hot, data.degrees(),
                            cfg.cache.budget_bytes,
                            feat_row_bytes=row_bytes,
                            group_size=cfg.cache.group_size,
                            granularity=cfg.cache.cost_model_granularity)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity} "
        f"topo_cap={cost.topo_capacity}")
    caps = observed_caps(max_per_hop, cfg.sampler.observed_cap_slack)

    topo = TopoCache.build(indptr, indices, cost.topo_order,
                           cost.topo_capacity)
    miss_cap = staging_rows(node_hot, cost.feat_order[:cost.feat_capacity],
                            steps, caps[-1])
    cache = FeatureCache.build(np.asarray(data.features), cost.feat_order,
                               cost.feat_capacity, miss_cap=miss_cap,
                               dtype=cache_dtype)
    hs = HybridSampler(topo, indptr, indices, fanouts, caps)

    # ---- model/state -------------------------------------------------------
    model = build_model(cfg.model.arch, cfg.model.hidden_dim, num_classes,
                        cfg.model.num_layers, cfg.model.dropout,
                        dtype=cfg.model.dtype)
    key = jax.random.PRNGKey(cfg.train.seed)
    batch0 = hs.sample_batch(key, jnp.asarray(seeds[0][0]), b,
                             jnp.zeros((b,), jnp.int32))
    x0 = jnp.zeros((caps[-1], data.feature_dim), jnp.float32)
    params = model.init(key, tuple(reversed(batch0.blocks)), x0,
                        deterministic=True)["params"]
    state = create_train_state(params, cfg.train.learning_rate,
                               cfg.train.seed)
    if cfg.train.checkpoint_dir:
        restored = restore_checkpoint(cfg.train.checkpoint_dir, state)
        if restored is not None:
            state = restored
            log(f"resumed from checkpoint at step {int(state.step)}, "
                f"epoch {int(state.epoch)}")

    from legion.runtime import gather_rows
    host_feats = np.asarray(data.features)
    labels_all = np.asarray(data.labels)
    tr = HybridTrainer(cfg, model, caps, topo, indptr, indices, cache,
                       host_stage=lambda ids: gather_rows(
                           host_feats, ids).astype(cache_dtype))

    def eval_set(ids: np.ndarray) -> float:
        if not len(ids):
            return float("nan")
        per_lim = min(cfg.sampler.eval_batch_size, b)
        steps_e = (len(ids) - 1) // per_lim + 1
        per = (len(ids) - 1) // steps_e + 1
        # hop-0 static shape must match training (the jits are shared)
        seeds_e, counts_e = epoch_eval_seeds([ids], steps_e, (per,), b)
        lab_e = np.where(seeds_e[0] >= 0,
                         labels_all[np.clip(seeds_e[0], 0, None)],
                         -1).astype(np.int32)
        return tr.eval_epoch(state.params, seeds_e[0], counts_e[0], lab_e)

    # ---- training ----------------------------------------------------------
    history = []
    start_epoch = int(jax.device_get(state.epoch))
    for epoch in range(start_epoch, cfg.train.epochs):
        ep_rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
        s, _ = epoch_train_seeds(ep_rng, shards, plan)
        lab = labels_all[s[0]].astype(np.int32)
        state = state.replace(epoch=jnp.full((), epoch, jnp.int32))
        r = tr.run_epoch(state, s[0], lab, epoch)
        state = r.pop("state")
        r["epoch"] = epoch
        r["valid"] = eval_set(np.asarray(data.valid_ids))
        history.append(r)
        from legion.utils.logging import eval_labels
        log(f"Epoch:{epoch}, Cost:{r['seconds']:.3f} s, "
            f"Loss:{r['loss']:.4f}, feat_hit:{r['feat_hit_rate']:.3f}, "
            f"topo_hot:{r['topo_hot_fraction']:.3f}, "
            f"{eval_labels(cfg)[0]}: {r['valid']:.4f}")
        if cfg.train.checkpoint_dir:
            state = state.replace(
                epoch=jnp.full((), epoch + 1, jnp.int32))
            save_checkpoint(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    from legion.utils.logging import eval_labels
    log(f"{eval_labels(cfg)[1]}: {test_acc:.4f}")
    return {"state": state, "history": history, "cost": cost,
            "sampler": hs, "trainer": tr, "test_acc": test_acc}
