#!/usr/bin/env python
"""Headline benchmark: GraphSAGE mini-batch training throughput (edges/s)
on a products-scale synthetic graph, one GPU.

Matches the reference's headline workload shape (GraphSAGE, hidden 256,
fanout [25,10], ~122M-edge / 2.45M-node graph with 100-dim features —
``legion_server.py:6-13,77-83``; batch 8000 = the reference default).
The full pipeline is measured: seed batching, on-device neighbor
sampling, dedup/renumber, feature gather, forward/backward, Adam.

Stage 1 probes realized frontier sizes and tightens the static caps
(the reference's 1.2 x observed MaxIdNum buffer sizing,
``src/Server.cu:273-282``); stage 2 times an epoch scan at tight caps.

vs_baseline = speedup over the scatter-based DGL-style SpMM formulation
(segment_sum over the COO edge list) running the identical pipeline —
i.e. what a direct port of the reference's aggregation would do.

Model compute defaults to bfloat16 mixed precision (f32 params/reduce;
convergence parity vs f32 is tested in tests/test_bf16.py).
BENCH_DTYPE=float32 reproduces the f32 measurement; the baseline is
always measured at the same dtype (memo key includes it).

Needs a GPU: without one it exits non-zero and prints no result. Prints
exactly ONE JSON line on stdout, naming the device it ran on.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
from legion.utils.compile_cache import configure_compile_cache
from legion.data.synthetic import bench_graph
from legion.models import build_model
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph, gather_features, sample_batch
from legion.train.loop import make_step_fns, sum_edge_counts
from legion.train.train_state import create_train_state

BATCH = int(os.environ.get("BENCH_BATCH", 8000))
# Measurement window: steps per timed epoch scan (the baseline is
# always measured at the SAME window; the memo key includes it).
STEPS = int(os.environ.get("BENCH_STEPS", 160))
NODES = int(os.environ.get("BENCH_NODES", 2_449_029))
DEG = int(os.environ.get("BENCH_DEG", 50))
DTYPE = os.environ.get("BENCH_DTYPE", "bfloat16")
# Slack multiplier over observed per-hop frontier maxima (the reference
# uses 1.2, src/Server.cu:275; per-hop unique counts concentrate tightly
# at batch 8000 so small slacks hold). Every step's frontier sizes are
# checked and the epoch asserts ZERO cap overflow, so a too-tight slack
# fails loudly rather than silently thinning neighborhoods.
SLACK = float(os.environ.get("BENCH_SLACK", 1.03))
# PRNG impl changes the draws, hence observed frontier maxima -> it is
# part of the caps/baseline memo keys.
PRNG = os.environ.get("BENCH_PRNG", "rbg")
FANOUTS = (25, 10)
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def shared_code_hash():
    """Content hash of every module on the baseline variant's code path.

    The baseline memo must invalidate itself when shared code changes
    (previously a manual delete documented in CLAUDE.md — a footgun:
    a stale baseline silently skews vs_baseline)."""
    import hashlib
    root = os.path.dirname(os.path.abspath(__file__))
    shared = [
        "legion/sampling/sampler.py",
        "legion/sampling/block.py",
        "legion/train/loop.py",
        "legion/models/sage.py",
        "legion/ops/segment.py",
        "legion/models/nn.py",
        "legion/cache/hotness.py",
    ]
    h = hashlib.sha256()
    for rel in shared:
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:10]


def load_or_gen():
    t0 = time.time()
    cache = os.path.join(CACHE_DIR, f"synth_{NODES}_{DEG}")
    if os.path.exists(os.path.join(cache, "meta.json")):
        from legion.data.format import load_dataset
        data = load_dataset(cache, mmap=False)
        log(f"graph loaded from cache {time.time() - t0:.1f}s")
    else:
        log(f"generating {NODES} nodes x deg {DEG} graph ...")
        data = bench_graph(num_nodes=NODES, avg_degree=DEG)
        from legion.data.format import save_dataset
        save_dataset(data, cache)
        log(f"graph gen {time.time() - t0:.1f}s; edges={data.num_edges}")
    return data


def probe_caps(graph, seeds, labels):
    """Measure realized per-hop frontier sizes, with disk memoization.

    Intermediate hops are tightened from observation (they dedup); the
    last cap is the exact identity-append extent (dedup_last=False)."""
    memo = os.path.join(
        CACHE_DIR, f"caps_nd_{NODES}_{DEG}_{BATCH}_s{SLACK}"
        + ("" if PRNG == "rbg" else f"_{PRNG}") + ".json")
    if os.path.exists(memo):
        caps = tuple(json.load(open(memo)))
        log(f"observed caps from cache: {caps}")
        return caps
    loose = frontier_caps(BATCH, FANOUTS)
    t0 = time.time()
    sb = jax.jit(sample_batch, static_argnums=(5, 6))
    mx = np.zeros(len(FANOUTS) + 1, np.int64)
    for i in range(3):
        b = sb(jax.random.PRNGKey(100 + i), graph, seeds[i],
               jnp.full((), BATCH, jnp.int32), labels[i], FANOUTS, loose)
        counts = [int(b.num_seeds)] + [int(blk.num_src) for blk in b.blocks]
        mx = np.maximum(mx, counts)
    from legion.cache.hotness import observed_caps
    caps = observed_caps(mx, slack=SLACK, align=128,
                         last_exact_fanout=FANOUTS[-1])
    log(f"cap probe {time.time() - t0:.1f}s: observed {mx.tolist()} "
        f"-> caps {caps} (loose {loose})")
    json.dump(list(caps), open(memo, "w"))
    return caps


def run_variant(agg, graph, feats, cfg, caps, seeds, labels):
    from legion.models.sage import SAGE
    model = SAGE(hidden_dim=cfg.model.hidden_dim,
                 out_dim=cfg.dataset.num_classes,
                 num_layers=cfg.model.num_layers,
                 dropout=cfg.model.dropout, agg=agg,
                 dtype=jnp.dtype(cfg.model.dtype))
    epoch_scan = make_step_fns(cfg, model, caps).epoch_scan

    import functools
    key = jax.random.PRNGKey(0)
    batch = jax.jit(functools.partial(sample_batch, dedup_last=False),
                    static_argnums=(5, 6))(
        key, graph, seeds[0], jnp.full((), BATCH, jnp.int32), labels[0],
        tuple(cfg.sampler.fanouts), caps)
    x = jax.jit(gather_features)(feats, batch.frontier)
    params = model.init(key, tuple(reversed(batch.blocks)), x,
                        deterministic=True)["params"]
    state = create_train_state(params, cfg.train.learning_rate, 0)

    jepoch = jax.jit(epoch_scan, donate_argnums=(0,))
    # warmup MUST use the same scan length (different leading dim =
    # recompile)
    t0 = time.perf_counter()
    state, losses, _ = jax.block_until_ready(
        jepoch(state, graph, feats, seeds, labels))
    log(f"[{agg}] compile+warmup {time.perf_counter() - t0:.1f}s")
    best = None
    for _trial in range(2):
        t0 = time.perf_counter()
        state, losses, (edges, overflow) = jax.block_until_ready(
            jepoch(state, graph, feats, seeds, labels))
        dt = time.perf_counter() - t0
        # edges is PER-STEP (steps,) int32: int64-safe epoch totals, see
        # train.loop.sum_edge_counts
        l, overflow = float(losses[-1]), int(overflow)
        e = float(sum_edge_counts(edges))
        best = min(best, dt) if best else dt
        assert overflow == 0, (
            f"frontier cap overflow ({overflow} ids dropped): "
            "loosen observed_cap_slack")
    eps = e / best
    log(f"[{agg}] {STEPS} steps in {best:.3f}s -> {eps:.3e} edges/s "
        f"(loss {l:.3f})")
    return eps, best / STEPS * 1e3


def main():
    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r} "
                 f"({dev.device_kind})")
    # PRNG implementation for dropout masks + sampling draws (same
    # distributions, different stream); an A/B against threefry on the
    # GPU is still open (ROADMAP).
    jax.config.update("jax_default_prng_impl", PRNG)

    data = load_or_gen()
    cfg = Config(
        dataset=DatasetConfig(num_classes=47),
        sampler=SamplerConfig(fanouts=FANOUTS, batch_size=BATCH),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype=DTYPE),
        train=TrainConfig(learning_rate=0.003),
    )
    from legion.data.format import pad_feature_dim
    graph = DeviceGraph.from_host(
        data.indptr, data.indices,
        layout=os.environ.get("BENCH_LAYOUT", "auto"))
    feats = jnp.asarray(pad_feature_dim(np.asarray(data.features)))

    rng = np.random.default_rng(0)
    ids = np.asarray(data.train_ids)
    seeds_np = np.stack([rng.permutation(ids)[:BATCH] for _ in range(STEPS)])
    labels_np = np.asarray(data.labels)[seeds_np]
    seeds = jnp.asarray(seeds_np.astype(np.int32))
    labels = jnp.asarray(labels_np.astype(np.int32))

    caps = probe_caps(graph, seeds, labels)

    eps_fanout, step_ms = run_variant("fanout", graph, feats, cfg, caps,
                                      seeds, labels)

    # Baseline (scatter-SpMM port) is deterministic given shapes; its
    # measurement is memoized so the default bench needs one compile.
    # Delete .bench_cache/baseline_*.json to force a re-measure.
    memo = os.path.join(
        CACHE_DIR, f"baseline_{NODES}_{DEG}_{BATCH}_{DTYPE}_s{SLACK}"
        + ("" if PRNG == "rbg" else f"_{PRNG}")
        + (f"_n{STEPS}" if STEPS != 20 else "")
        + f"_h{shared_code_hash()}" + ".json")
    if os.path.exists(memo):
        eps_coo = json.load(open(memo))["edges_per_s"]
        log(f"[coo_segment] baseline from cache: {eps_coo:.3e} edges/s")
    else:
        eps_coo, _ = run_variant("coo_segment", graph, feats, cfg, caps,
                                 seeds, labels)
        json.dump({"edges_per_s": eps_coo}, open(memo, "w"))

    print(json.dumps({
        "metric": "train_edges_per_s",
        "value": eps_fanout,
        "unit": "edges/s",
        "vs_baseline": eps_fanout / eps_coo,
        "step_ms": step_ms,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
