"""Multi-chip hybrid-placement driver: host CSR + Kg-striped hot sub-CSR
+ Kg-striped hot feature cache on a (data x cache) mesh.

The last reference configuration to land: the
uk2014/clueweb-class placement (topology AND features beyond device HBM)
running on every chip simultaneously, as the reference does with its
hybrid sampling + clique-striped caches on all 8 GPUs
(``src/Server.cu:116-133``, ``src/Kernels.cu:387-397``,
``src/GPUCache.cu:88-141``). Lifecycle mirrors the reference server:
Initialize -> PreSc(host) -> cost model -> striped cache fill -> Run,
with per-epoch validation, final test, and checkpoint/resume.

The cost model sees BOTH placements as cacheable here — this is the one
driver where the feature-vs-topology budget split actually trades real
host bytes on both sides (the situation ``src/GPUCache.cu:661-767`` was
built for).
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.cost_model import solve_cost_model
from legion.cache.feature_cache import cache_dtype_for
from legion.cache.hotness import observed_caps, staging_rows
from legion.cache.striped import StripedFeatureCache, StripedTopoCache
from legion.cache.striped_hybrid import StripedHybridTrainer
from legion.config import Config
from legion.data.format import GraphData
from legion.models import build_model
from legion.sampling.seeds import (
    epoch_eval_seeds, epoch_train_seeds, interleave_shards, make_seed_plan,
    shard_node_set)
from legion.train.hybrid_driver import presample_hotness_host
from legion.train.train_state import (
    create_train_state, restore_checkpoint, save_checkpoint)


def _probe_owner_caps(indptr, indices, seeds_batches, fanouts, caps,
                      hot_topo, hot_feat, kg, seed=0):
    """Observed per-owner request maxima for the striped exchanges,
    measured host-side: frontiers are re-grown with
    the shared probe engine (cache.hotness.host_frontier_probe), then
    each hop's topo-hit ranks and the final frontier's feature-hit
    ranks are histogrammed by owner chip (owner = rank % Kg). Returns
    (per-hop topo caps, feature cap) at ~1.05x the observed maxima —
    demotion to the host path remains the loud backstop for bursts
    beyond the probe."""
    from legion.cache.hotness import host_frontier_probe
    from legion.parallel.feature_exchange import probed_owner_cap
    rng = np.random.default_rng(seed * 9176 + 13)
    h = len(fanouts)
    tmax = np.zeros(h, np.int64)
    fmax = np.zeros(1, np.int64)

    def hit_ranks(hot_sorted, ids):
        if len(hot_sorted) == 0 or len(ids) == 0:
            return np.empty(0, np.int64)
        pos = np.clip(np.searchsorted(hot_sorted, ids), 0,
                      len(hot_sorted) - 1)
        return pos[hot_sorted[pos] == ids]

    def omax(ranks):
        if not len(ranks):
            return 0
        return int(np.bincount(ranks % kg, minlength=kg).max())

    def visit(hop, frontier):
        if hop < h:
            tmax[hop] = max(tmax[hop],
                            omax(hit_ranks(hot_topo, frontier)))
        else:
            fmax[0] = max(fmax[0], omax(hit_ranks(hot_feat, frontier)))

    host_frontier_probe(indptr, indices, seeds_batches, fanouts, caps,
                        visit, rng, seed_base=7700 + seed * 131)

    tcaps = tuple(probed_owner_cap(int(tmax[k]), caps[k], kg)
                  for k in range(h))
    return tcaps, probed_owner_cap(int(fmax[0]), caps[-1], kg)


def run_striped_hybrid_training(cfg: Config, data: GraphData, mesh=None,
                                log=print) -> Dict:
    from legion.parallel.mesh import make_mesh
    if mesh is None:
        mesh = make_mesh(cfg.parallel.num_devices,
                         cache_group_size=cfg.cache.group_size)
    n = mesh.devices.size
    kg = mesh.shape["cache"]

    indptr = np.ascontiguousarray(np.asarray(data.indptr), np.int64)
    indices = np.ascontiguousarray(np.asarray(data.indices), np.int32)
    num_classes = cfg.dataset.num_classes or data.num_classes
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)

    shards = shard_node_set(np.asarray(data.train_ids), n)
    plan = make_seed_plan([len(s) for s in shards],
                          [max(len(data.valid_ids), 1)] * n,
                          [max(len(data.test_ids), 1)] * n, b,
                          cfg.sampler.eval_batch_size)
    rng = np.random.default_rng(cfg.train.seed)
    seeds, _ = epoch_train_seeds(rng, shards, plan)     # (n, steps, b)

    # ---- presampling (host CSR) over every shard's stream ------------------
    t0 = time.perf_counter()
    steps = cfg.cache.presample_steps or plan.train_steps
    pres_seeds = seeds[:, :steps].reshape(-1, b)        # (n*steps, b)
    node_hot, edge_hot, max_per_hop = presample_hotness_host(
        indptr, indices, pres_seeds, fanouts, data.num_nodes,
        cfg.train.seed)
    log(f"host presampling: {pres_seeds.shape[0]} steps in "
        f"{time.perf_counter()-t0:.1f}s")

    # ---- cost model: real feature-vs-topology split (both host-resident) ---
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    cost = solve_cost_model(node_hot, edge_hot, data.degrees(),
                            cfg.cache.budget_bytes,
                            feat_row_bytes=row_bytes, group_size=kg,
                            granularity=cfg.cache.cost_model_granularity)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity}"
        f" topo_cap={cost.topo_capacity} (x{kg} chips/group)")
    caps = observed_caps(max_per_hop, cfg.sampler.observed_cap_slack)

    topo = StripedTopoCache.build(indptr, indices, cost.topo_order,
                                  cost.topo_capacity, mesh)
    # per-chip staging: node_hot counts every presampled batch (n per step)
    miss_cap = staging_rows(node_hot, cost.feat_order[:cost.feat_capacity],
                            pres_seeds.shape[0], caps[-1])
    host_feats = np.asarray(data.features)

    # probe-size the exchange owner caps (~1.05x observed per-owner
    # maxima; static 2x fallback on a 1-chip cache axis)
    tcaps = None
    ocap_feat = None
    if kg > 1:
        topo_cap_n = int(min(cost.topo_capacity, len(cost.topo_order)))
        feat_cap_n = int(min(cost.feat_capacity, len(cost.feat_order)))
        hot_topo = np.sort(np.asarray(
            cost.topo_order[:topo_cap_n], np.int64))
        hot_feat = np.sort(np.asarray(
            cost.feat_order[:feat_cap_n], np.int64))
        tcaps, ocap_feat = _probe_owner_caps(
            indptr, indices, seeds[0][: min(2, seeds.shape[1])],
            fanouts, caps, hot_topo, hot_feat, kg, seed=cfg.train.seed)
        log(f"owner-cap probe (Kg={kg}): topo {tcaps}, feat {ocap_feat}")
    fcache = StripedFeatureCache.build(host_feats, cost.feat_order,
                                       cost.feat_capacity, miss_cap, mesh,
                                       dtype=cache_dtype,
                                       owner_cap_rows=ocap_feat)

    # ---- model/state --------------------------------------------------------
    model = build_model(cfg.model.arch, cfg.model.hidden_dim, num_classes,
                        cfg.model.num_layers, cfg.model.dropout,
                        dtype=cfg.model.dtype)
    key = jax.random.PRNGKey(cfg.train.seed)
    # param init only needs SHAPES: a tiny single-chip hybrid batch gives
    # blocks with the production caps/fanouts layout
    from legion.cache.hybrid import HybridSampler
    from legion.cache.topo_cache import TopoCache
    init_hs = HybridSampler(
        TopoCache.build(indptr, indices, cost.topo_order, 1),
        indptr, indices, fanouts, caps)
    batch0 = init_hs.sample_batch(key, jnp.asarray(seeds[0][0]), b,
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

    # ---- training (Run) ------------------------------------------------------
    from legion.runtime import gather_rows
    tr = StripedHybridTrainer(
        cfg, model, caps, topo, indptr, indices, fcache, mesh,
        host_stage=lambda ids: gather_rows(host_feats, ids)
        .astype(cache_dtype), topo_owner_caps=tcaps)
    labels_all = np.asarray(data.labels)

    def eval_set(ids: np.ndarray) -> float:
        if not len(ids):
            return float("nan")
        eshards = shard_node_set(ids, n)
        per_lim = min(cfg.sampler.eval_batch_size, b)
        mx = max(max(len(s) for s in eshards), 1)
        steps_e = (mx - 1) // per_lim + 1
        per = tuple((len(s) - 1) // steps_e + 1 if len(s) else 0
                    for s in eshards)
        seeds_e, counts_e = epoch_eval_seeds(eshards, steps_e, per, b)
        lab_e = np.where(seeds_e >= 0,
                         labels_all[np.clip(seeds_e, 0, None)],
                         -1).astype(np.int32)
        return tr.eval_epoch(state.params, interleave_shards(seeds_e),
                             counts_e.swapaxes(0, 1),
                             interleave_shards(lab_e))

    history = []
    start_epoch = int(jax.device_get(state.epoch))
    for epoch in range(start_epoch, cfg.train.epochs):
        ep_rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
        s, _ = epoch_train_seeds(ep_rng, shards, plan)   # (n, steps, b)
        lab = labels_all[s].astype(np.int32)
        state = state.replace(epoch=jnp.full((), epoch, jnp.int32))
        r = tr.run_epoch(state, interleave_shards(s),
                         interleave_shards(lab), epoch)
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
            "trainer": tr, "test_acc": test_acc,
            "mesh": dict(mesh.shape)}
