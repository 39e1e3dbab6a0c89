#!/usr/bin/env python
"""Multi-chip scaling study harness.

Measures train-step edges/s of the DP path at 1..K chips. By default
(CPU-only) it runs on an 8-device virtual CPU mesh, which validates the
sharded program and the efficiency *accounting* but not real
interconnect bandwidth; SCALING_ON_DEVICES=1 measures on the host's
GPUs instead.

Usage: python tools/bench_scaling.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

# CPU-only by default: an 8-device virtual CPU mesh, selected via
# jax.config while backends are uninitialized. SCALING_ON_DEVICES=1
# measures on the machine's real devices instead.
if not os.environ.get("SCALING_ON_DEVICES"):
    try:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    except RuntimeError:
        pass  # backend already live


def main():
    if jax.default_backend() == "cpu":
        print("NOTE: virtual CPU mesh — program validation only, not a "
              "hardware scaling measurement", file=sys.stderr)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
    from legion.data.synthetic import random_power_law_graph
    from legion.models import build_model
    from legion.parallel.dp import make_dp_train_step
    from legion.parallel.mesh import make_mesh
    from legion.sampling.block import frontier_caps
    from legion.sampling.sampler import DeviceGraph, gather_features, sample_batch
    from legion.train.train_state import create_train_state

    data = random_power_law_graph(num_nodes=100_000, avg_degree=15,
                                  feature_dim=64, num_classes=32, seed=0)
    b, fanouts = 512, (10, 5)
    cfg = Config(dataset=DatasetConfig(num_classes=32),
                 sampler=SamplerConfig(fanouts=fanouts, batch_size=b),
                 model=ModelConfig(arch="sage", hidden_dim=128, num_layers=2,
                                   dropout=0.0),
                 train=TrainConfig(learning_rate=0.003))
    caps = frontier_caps(b, fanouts)
    graph = DeviceGraph.from_host(data.indptr, data.indices)
    feats = jnp.asarray(np.asarray(data.features))
    model = build_model("sage", 128, 32, 2, 0.0)

    batch0 = jax.jit(sample_batch, static_argnums=(5, 6))(
        jax.random.PRNGKey(0), graph, jnp.arange(b, dtype=jnp.int32),
        jnp.full((), b, jnp.int32), jnp.zeros((b,), jnp.int32), fanouts, caps)
    x0 = jax.jit(gather_features)(feats, batch0.frontier)
    params = model.init(jax.random.PRNGKey(0),
                        tuple(reversed(batch0.blocks)), x0,
                        deterministic=True)["params"]

    from jax.sharding import Mesh
    from legion.data.partition import partition_graph
    from legion.parallel.multihost import (
        AXIS, make_partitioned_train_step)

    from legion.cache.feature_cache import FeatureCache
    from legion.cache.striped import StripedFeatureCache
    from legion.cache.striped_pipeline import StripedCachedTrainer

    ndev = len(jax.devices())
    results, results_part, results_striped = {}, {}, {}
    striped_hit, striped_demoted, part_overflow = {}, {}, {}
    sizes = [k for k in (1, 2, 4, 8, 16) if k <= ndev]
    ids = np.asarray(data.train_ids)
    rng = np.random.default_rng(0)
    reps = 10
    for k in sizes:
        mesh = make_mesh(k, cache_group_size=1)
        step, _ = make_dp_train_step(cfg, model, caps, mesh)
        state = create_train_state(
            jax.tree_util.tree_map(jnp.copy, params), 0.003, 0)
        total = k * b
        seeds = jnp.asarray(rng.permutation(ids)[:total].astype(np.int32))
        labels = jnp.asarray(np.asarray(data.labels)[np.asarray(seeds)])
        sh = NamedSharding(mesh, P(("data", "cache")))
        s = jax.device_put(seeds, sh)
        l = jax.device_put(labels, sh)
        nb = jnp.full((), b, jnp.int32)
        state, m = step(state, graph, feats, s, nb, l)
        _ = float(m["loss"])
        t0 = time.perf_counter()
        for _i in range(reps):
            state, m = step(state, graph, feats, s, nb, l)
        e = float(m["edges"]); _ = float(m["loss"])
        dt = (time.perf_counter() - t0) / reps
        results[k] = e / dt
        print(f"{k} chips DP: {e / dt:.3e} edges/s", file=sys.stderr,
              flush=True)

        # ---- edge-partitioned path at the same size (exact halo) -------
        from legion.parallel.multihost import probe_dist_caps
        pmesh = Mesh(np.array(jax.devices()[:k]), (AXIS,))
        part = partition_graph(data, k, mode="greedy")
        # probe with the same seed distribution the bench feeds (random
        # split, NOT partition-local — mirrors ps below)
        dcaps = probe_dist_caps(
            data.indptr, data.indices, part,
            np.array_split(np.random.default_rng(5).permutation(ids), k),
            cfg.sampler.fanouts, caps, k, b) if k > 1 else ()
        pstep, put_shards = make_partitioned_train_step(
            cfg, model, caps, pmesh, dist_caps=dcaps)
        shard_args = put_shards(data.indptr, data.indices, data.features,
                                part)
        pstate = create_train_state(
            jax.tree_util.tree_map(jnp.copy, params), 0.003, 0)
        psh = NamedSharding(pmesh, P(AXIS))
        ps = jax.device_put(seeds, psh)
        pl = jax.device_put(labels, psh)
        pnb = jax.device_put(np.full((k,), b, np.int32), psh)
        pstate, m = pstep(pstate, *shard_args, ps, pnb, pl)
        _ = float(m["loss"])
        # accumulate overflow across EVERY rep (each rep samples under a
        # different step key, so any rep can drop) — as device adds, so
        # the timed loop stays free of host fetches; the add itself is
        # warmed (compiled) before t0, and the single accumulated-scalar
        # fetch happens AFTER dt is captured
        ov_dev = (m.get("halo_overflow", jnp.zeros((), jnp.int32))
                  + jnp.zeros((), jnp.int32))
        t0 = time.perf_counter()
        for _i in range(reps):
            pstate, m = pstep(pstate, *shard_args, ps, pnb, pl)
            ov_dev = ov_dev + m.get("halo_overflow", 0)
        # the edges/loss fetches ARE the sync (same idiom as the DP leg
        # above); only the overflow fetch — an extra round-trip — waits
        # until after dt is captured
        e = float(m["edges"]); _ = float(m["loss"])
        dt = (time.perf_counter() - t0) / reps
        halo_ov = int(ov_dev)
        results_part[k] = e / dt
        part_overflow[k] = halo_ov
        if halo_ov:
            print(f"WARNING: {k}-chip partitioned leg dropped {halo_ov} "
                  "halo requests (probed caps too tight for this seed "
                  "distribution) — partitioned numbers understate comm",
                  file=sys.stderr, flush=True)
        print(f"{k} chips partitioned: {e / dt:.3e} edges/s "
              f"(halo_overflow={halo_ov})",
              file=sys.stderr, flush=True)

        # ---- Kg-striped hot cache at the same size (whole mesh = one
        # clique: each chip holds capacity/k hot rows, hits served by
        # collective exchange, misses staged from host) ------------------
        smesh = make_mesh(k, cache_group_size=k)
        feats_np = np.asarray(data.features)
        deg_order = np.argsort(
            -np.diff(np.asarray(data.indptr))).astype(np.int32)
        capacity = feats_np.shape[0] // 4
        # probe the per-owner exchange cap (~1.05x observed maxima, the
        # striped driver's procedure) so the measured exchange runs at
        # the production volume, not the static 2x fallback
        ocap = None
        if k > 1:
            from legion.cache.feature_cache import FeatureCache as _FC
            from legion.parallel.feature_exchange import (
                owner_counts, probed_owner_cap)
            from legion.sampling.sampler import sample_batch
            hot_probe = jnp.asarray(
                np.sort(deg_order[:capacity]).astype(np.int32))

            def _probe(key, g, hot_sorted, seeds_b):
                pb = sample_batch(key, g, seeds_b,
                                  jnp.full((), b, jnp.int32),
                                  jnp.zeros((b,), jnp.int32),
                                  tuple(cfg.sampler.fanouts), caps,
                                  dedup_last=True)
                plan = _FC.plan_ids(hot_sorted, pb.frontier, 128)
                return owner_counts(
                    jnp.where(plan.hit, plan.slot, -1), k)

            jp = jax.jit(_probe)
            omax = 0
            for i in range(2):
                sb = np.random.default_rng(60 + i).permutation(
                    ids)[:b].astype(np.int32)
                omax = max(omax, int(np.asarray(jp(
                    jax.random.PRNGKey(8800 + i), graph, hot_probe,
                    jnp.asarray(sb))).max()))
            ocap = probed_owner_cap(omax, caps[-1], k)
        scache = StripedFeatureCache.build(feats_np, deg_order, capacity,
                                           miss_cap=caps[-1], mesh=smesh,
                                           owner_cap_rows=ocap)
        fc = FeatureCache.build(feats_np, deg_order, capacity,
                                miss_cap=caps[-1])
        tr = StripedCachedTrainer(cfg, model, caps, graph, scache, smesh,
                                  host_stage=fc.stage)
        sstate = create_train_state(
            jax.tree_util.tree_map(jnp.copy, params), 0.003, 0)
        seeds_ep = np.stack([
            rng.permutation(ids)[:total].astype(np.int32)
            for _ in range(reps)])
        labels_ep = np.asarray(data.labels)[seeds_ep].astype(np.int32)
        # warmup epoch compiles the two shard_mapped programs
        r = tr.run_epoch(sstate, seeds_ep[:2], labels_ep[:2])
        r = tr.run_epoch(r["state"], seeds_ep, labels_ep)
        results_striped[k] = r["edges_per_s"]
        striped_hit[k] = r["cache_hit_rate"]
        striped_demoted[k] = r["exchange_overflow"]
        print(f"{k} chips striped-cache (Kg={k}): "
              f"{r['edges_per_s']:.3e} edges/s "
              f"hit={r['cache_hit_rate']:.3f} ocap={ocap} "
              f"demoted={r['exchange_overflow']}",
              file=sys.stderr, flush=True)

    base = results[sizes[0]]
    effs = {k: results[k] / (base * k / sizes[0]) for k in sizes}
    ratio = {k: results_part[k] / results[k] for k in sizes}
    print(json.dumps({
        "metric": "dp_scaling_edges_per_s",
        "per_size": {str(k): round(v, 1) for k, v in results.items()},
        "efficiency": {str(k): round(v, 3) for k, v in effs.items()},
        "partitioned_per_size": {str(k): round(v, 1)
                                 for k, v in results_part.items()},
        "partitioned_vs_dp": {str(k): round(v, 3)
                              for k, v in ratio.items()},
        "partitioned_halo_overflow": {str(k): v
                                      for k, v in part_overflow.items()},
        "striped_per_size": {str(k): round(v, 1)
                             for k, v in results_striped.items()},
        "striped_hit_rate": {str(k): round(v, 3)
                             for k, v in striped_hit.items()},
        "striped_demoted": {str(k): v
                            for k, v in striped_demoted.items()},
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
