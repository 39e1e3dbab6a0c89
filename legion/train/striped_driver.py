"""Multi-chip cached-training driver: the full reference lifecycle
``Initialize -> PreSc -> Run`` on a (data x cache) device mesh.

This is the configuration the reference actually ships as "Legion": N
GPU runners training data-parallel (``src/Server.cu:116-133``), the hot
feature cache striped across each NVLink clique
(``src/GPUCache.cu:103-141``) and the epoch/valid/test mode schedule
(``src/CUDA_IPC_Service.cu:246-259``, ``legion_graphsage.py:149-181``).
Here: presampling measures hotness, the cost model splits the
group-aggregate HBM budget, the hot rows are striped over the ``cache``
mesh axis (StripedFeatureCache), and training runs the double-buffered
mesh pipeline with per-epoch validation, a final test pass, and .npz
checkpoint/resume (beyond-reference: the reference loses a crashed run).
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.cost_model import solve_cost_model
from legion.cache.feature_cache import FeatureCache, cache_dtype_for
from legion.cache.hotness import (observed_caps, presample_hotness,
                                  staging_rows)
from legion.cache.striped import StripedFeatureCache
from legion.cache.striped_pipeline import StripedCachedTrainer
from legion.config import Config
from legion.data.format import GraphData
from legion.models import build_model
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph, sample_batch
from legion.sampling.seeds import (
    interleave_shards,
    epoch_eval_seeds, epoch_train_seeds, make_seed_plan, shard_node_set)
from legion.train.train_state import (
    create_train_state, restore_checkpoint, save_checkpoint)


def _round128(x):
    return (int(x) + 127) // 128 * 128




def run_striped_training(cfg: Config, data: GraphData, mesh=None,
                         log=print) -> Dict:
    from legion.parallel.mesh import make_mesh
    if mesh is None:
        mesh = make_mesh(cfg.parallel.num_devices,
                         cache_group_size=cfg.cache.group_size)
    n = mesh.devices.size
    kg = mesh.shape["cache"]

    graph = DeviceGraph.from_host(data.indptr, data.indices)
    num_classes = cfg.dataset.num_classes or data.num_classes
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)
    loose_caps = frontier_caps(b, fanouts)

    # per-chip train shards + lockstep step plan (Coordinate rule)
    shards = shard_node_set(np.asarray(data.train_ids), n)
    plan = make_seed_plan([len(s) for s in shards],
                          [max(len(data.valid_ids), 1)] * n,
                          [max(len(data.test_ids), 1)] * n, b,
                          cfg.sampler.eval_batch_size)
    rng = np.random.default_rng(cfg.train.seed)
    seeds, _ = epoch_train_seeds(rng, shards, plan)   # (n, steps, b)

    # ---- presampling (PreSc): hotness over every shard's stream ----------
    t0 = time.perf_counter()
    steps = cfg.cache.presample_steps or plan.train_steps
    pres_seeds = seeds[:, :steps].reshape(-1, b)      # (n*steps, b)
    hot = presample_hotness(
        jax.random.PRNGKey(cfg.train.seed), graph,
        jnp.asarray(pres_seeds),
        jnp.full((pres_seeds.shape[0],), b, jnp.int32), fanouts,
        loose_caps, data.num_nodes)
    log(f"presampling: {pres_seeds.shape[0]} steps in "
        f"{time.perf_counter()-t0:.1f}s, "
        f"max frontier {int(hot.max_frontier)}/{loose_caps[-1]}")

    # ---- cost model + striped cache build ---------------------------------
    cache_dtype, row_bytes = cache_dtype_for(cfg.model.dtype,
                                             data.feature_dim)
    # topology is HBM-resident here (DeviceGraph): zero topo savings,
    # full budget to the striped feature cache (placement-aware model).
    cost = solve_cost_model(
        np.asarray(hot.node_hot), np.asarray(hot.edge_hot),
        data.degrees(), cfg.cache.budget_bytes,
        feat_row_bytes=row_bytes, group_size=kg,
        granularity=cfg.cache.cost_model_granularity,
        topo_cacheable=False)
    log(f"cost model: alpha={cost.alpha:.2f} feat_cap={cost.feat_capacity}"
        f" (x{kg} chips/group) topo_cap={cost.topo_capacity}")

    caps = observed_caps(hot.max_per_hop, cfg.sampler.observed_cap_slack)

    # staging sized by cache.hotness.staging_rows, floored at a probe of
    # misses per batch; the SAME probe observes per-owner hit-request
    # maxima, sizing the exact exchange's owner cap at ~1.05x observed
    # instead of the static 2x-of-M/K fallback (takes the exchange to
    # ~the requested rows, the reference's exactly-requested-bytes P2P
    # bar, src/Kernels.cu:695-699; over-cap hits still demote loudly).
    # Probe batches: two fresh draws from the shards, whose misses are
    # unbiased (the presample estimate biases low, see cached_driver),
    # and the first two presampled batches, which the hot set was fit
    # to and so send the most hits per owner (with seed 0 they are also
    # epoch 0's batches).
    from legion.parallel.feature_exchange import (
        owner_counts, probed_owner_cap)
    cached_ids = np.asarray(cost.feat_order[:cost.feat_capacity])
    hot_probe = jnp.asarray(np.sort(cached_ids.astype(np.int32)))

    def _probe(key, g, hot_sorted, seeds_b, labels_b):
        batch = sample_batch(key, g, seeds_b, jnp.full((), b, jnp.int32),
                             labels_b, fanouts, tuple(caps),
                             dedup_last=True)
        plan = FeatureCache.plan_ids(hot_sorted, batch.frontier, 128)
        req = jnp.where(plan.hit, plan.slot, -1)
        return plan.num_miss, owner_counts(req, max(kg, 1))

    jprobe = jax.jit(_probe)
    prng = np.random.default_rng(cfg.train.seed * 31 + 7)
    probes = [prng.permutation(shards[i % len(shards)])[:b]
              for i in range(2)] + list(pres_seeds[:2])
    probe_miss = owner_max = 0
    for i, sb in enumerate(probes):
        sb = np.asarray(sb, np.int32)
        if len(sb) < b:
            sb = np.pad(sb, (0, b - len(sb)), constant_values=-1)
        nm, oc = jprobe(jax.random.PRNGKey(9000 + i), graph, hot_probe,
                        jnp.asarray(sb), jnp.zeros((b,), jnp.int32))
        probe_miss = max(probe_miss, int(nm))
        owner_max = max(owner_max, int(np.asarray(oc).max()))
    miss_cap = staging_rows(np.asarray(hot.node_hot), cached_ids,
                            pres_seeds.shape[0], caps[-1], floor=probe_miss)
    ocap = (probed_owner_cap(owner_max, caps[-1], kg) if kg > 1 else None)
    log(f"staging: probe max {probe_miss} misses/step, miss_cap "
        f"{miss_cap}/chip (frontier cap {caps[-1]}); owner cap "
        f"{ocap} (probe max {owner_max}/owner, Kg={kg})")

    host_feats = np.asarray(data.features)
    cache = StripedFeatureCache.build(host_feats, cost.feat_order,
                                      cost.feat_capacity, miss_cap, mesh,
                                      dtype=cache_dtype,
                                      owner_cap_rows=ocap)

    # ---- model/state -------------------------------------------------------
    model = build_model(cfg.model.arch, cfg.model.hidden_dim, num_classes,
                        cfg.model.num_layers, cfg.model.dropout,
                        dtype=cfg.model.dtype)
    key = jax.random.PRNGKey(cfg.train.seed)
    batch0 = jax.jit(sample_batch, static_argnums=(5, 6))(
        key, graph, jnp.asarray(seeds[0][0]), jnp.full((), b, jnp.int32),
        jnp.zeros((b,), jnp.int32), fanouts, tuple(caps))
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

    # ---- training (Run) ----------------------------------------------------
    from legion.runtime import gather_rows
    tr = StripedCachedTrainer(
        cfg, model, caps, graph, cache, mesh,
        host_stage=lambda ids: gather_rows(host_feats, ids)
        .astype(cache_dtype))

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
        s, _ = epoch_train_seeds(ep_rng, shards, plan)      # (n, steps, b)
        lab = labels_all[s]
        state = state.replace(epoch=jnp.full((), epoch, jnp.int32))
        r = tr.run_epoch(state, interleave_shards(s),
                         interleave_shards(lab.astype(np.int32)))
        state = r.pop("state")
        if r["staging_overflow"] > 0 and miss_cap < caps[-1]:
            # grow staging past the worst observed per-step need and
            # rebuild (one recompile); overflowed rows in the epoch just
            # run read as zeros (reported below) — same recovery as
            # cached_driver's single-chip path.
            need = miss_cap + r["staging_overflow"] / max(r["steps"], 1)
            miss_cap = int(min(caps[-1], _round128(need * 2.0)))
            log(f"staging overflow -> growing miss_cap to {miss_cap}")
            cache = StripedFeatureCache.build(
                host_feats, cost.feat_order, cost.feat_capacity,
                miss_cap, mesh, dtype=cache_dtype, owner_cap_rows=ocap)
            tr = StripedCachedTrainer(
                cfg, model, caps, graph, cache, mesh,
                host_stage=lambda ids: gather_rows(host_feats, ids)
                .astype(cache_dtype))
        r["epoch"] = epoch
        r["valid"] = eval_set(np.asarray(data.valid_ids))
        history.append(r)
        from legion.utils.logging import eval_labels
        log(f"Epoch:{epoch}, Cost:{r['seconds']:.3f} s, "
            f"Loss:{r['loss']:.4f}, hit:{r['cache_hit_rate']:.3f}, "
            f"host_gb:{r['host_gb']:.3f}, "
            f"edges/s:{r['edges_per_s']:.3e}, "
            f"{eval_labels(cfg)[0]}: {r['valid']:.4f}"
            + (f" [STAGING OVERFLOW {r['staging_overflow']} rows]"
               if r.get("staging_overflow") else ""))
        if cfg.train.checkpoint_dir:
            state = state.replace(
                epoch=jnp.full((), epoch + 1, jnp.int32))
            save_checkpoint(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    from legion.utils.logging import eval_labels
    log(f"{eval_labels(cfg)[1]}: {test_acc:.4f}")
    return {"state": state, "history": history, "cost": cost,
            "test_acc": test_acc, "mesh": dict(mesh.shape)}
