#!/usr/bin/env python
"""Probed owner caps at bench shapes: measure the demotion rate
(VERDICT r4 next #1 'publish the measured demotion rate at the chosen
slack').

On the real bench graph (products-scale synthetic, batch 8000, fanout
[25,10], dedup'd frontier), build a hotness-ordered cache set, size the
per-owner exchange cap from 2 probe batches at PROBED_OWNER_SLACK
(1.05x the observed per-owner hit maximum — the striped drivers'
procedure), then stream many FRESH batches and count the hit requests
each owner cap would demote to the host path. One JSON line per
(cache-group size Kg): cap, total hits, demoted count, demotion rate.

Round-robin striping spreads a frontier's hit RANKS binomially over
owners (fluctuation ~sqrt(H/K) around H/K), so the expected rate is
~zero at 1.05x; a persistently nonzero rate here is the signal to
raise the slack. Runs on the GPU (sampling is jitted); the
exchange itself never runs — demotion is a pure function of
(hot set, frontier, cap)."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.feature_cache import FeatureCache
from legion.parallel.feature_exchange import (
    PROBED_OWNER_SLACK, owner_cap, owner_counts, probed_owner_cap)
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph, sample_batch
from legion.utils.compile_cache import configure_compile_cache

BATCH = int(os.environ.get("BENCH_BATCH", 8000))
FANOUTS = (25, 10)
CACHE_GB = float(os.environ.get("CAP_CACHE_GB", 1.0))
BATCHES = int(os.environ.get("CAP_BATCHES", 50))
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench_cache")


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    configure_compile_cache()
    from legion.data.format import load_dataset
    cache = os.path.join(CACHE_DIR, "synth_2449029_50")
    data = load_dataset(cache, mmap=False)
    graph = DeviceGraph.from_host(data.indptr, data.indices)
    caps_memo = os.path.join(CACHE_DIR, "caps_nd_2449029_50_8000_s1.03.json")
    caps = (tuple(json.load(open(caps_memo))) if os.path.exists(caps_memo)
            else frontier_caps(BATCH, FANOUTS))
    m = caps[-1]
    log(f"caps {caps}")

    # hotness proxy consistent with the striped driver: in-degree order
    # (the bench graph's Zipf sources make degree ~ access frequency);
    # capacity = the bf16 budget's row count
    order = np.argsort(-np.asarray(data.degrees())).astype(np.int32)
    capacity = int(min(CACHE_GB * 2 ** 30 // (128 * 2), data.num_nodes))
    hot = jnp.asarray(np.sort(order[:capacity]))
    log(f"hot set {capacity} rows ({CACHE_GB} GB bf16)")

    kgs = [2, 4, 8]

    # one program returning per-owner counts for every Kg at once
    def prog(key, g, hot_sorted, seeds_b):
        batch = sample_batch(key, g, seeds_b,
                             jnp.full((), BATCH, jnp.int32),
                             jnp.zeros((BATCH,), jnp.int32),
                             FANOUTS, tuple(caps), dedup_last=True)
        plan = FeatureCache.plan_ids(hot_sorted, batch.frontier, 128)
        req = jnp.where(plan.hit, plan.slot, -1)
        out = [plan.num_hit]
        for kg in kgs:
            c = owner_counts(req, kg)
            out.append(jnp.pad(c, (0, max(kgs) - kg)))
        return jnp.concatenate([out[0][None]]
                               + [c for c in out[1:]])

    jprog = jax.jit(prog)
    ids = np.asarray(data.train_ids)
    rng = np.random.default_rng(123)

    def batch_counts(i, seed_base):
        sb = rng.permutation(ids)[:BATCH].astype(np.int32)
        packed = np.asarray(jprog(jax.random.PRNGKey(seed_base + i),
                                  graph, hot, jnp.asarray(sb)))
        hits = int(packed[0])
        per_kg = {}
        off = 1
        for kg in kgs:
            per_kg[kg] = packed[off: off + kg].astype(np.int64)
            off += max(kgs)
        return hits, per_kg

    t0 = time.time()
    # probe phase: 2 batches (the drivers' procedure)
    probe_max = {kg: 0 for kg in kgs}
    for i in range(2):
        _, per = batch_counts(i, 9000)
        for kg in kgs:
            probe_max[kg] = max(probe_max[kg], int(per[kg].max()))
    cap_by_kg = {kg: probed_owner_cap(probe_max[kg], m, kg)
                 for kg in kgs}
    log(f"probe {time.time()-t0:.1f}s: maxima {probe_max} -> caps "
        f"{cap_by_kg} (static fallback "
        f"{ {kg: owner_cap(m, kg) for kg in kgs} })")

    # measurement phase: fresh batches
    tot_hits = 0
    demoted = {kg: 0 for kg in kgs}
    worst = {kg: 0 for kg in kgs}
    for i in range(BATCHES):
        hits, per = batch_counts(i, 50_000)
        tot_hits += hits
        for kg in kgs:
            demoted[kg] += int(np.maximum(
                per[kg] - cap_by_kg[kg], 0).sum())
            worst[kg] = max(worst[kg], int(per[kg].max()))
    log(f"measured {BATCHES} batches in {time.time()-t0:.1f}s")

    for kg in kgs:
        print(json.dumps({
            "kg": kg, "slack": PROBED_OWNER_SLACK,
            "probed_cap": cap_by_kg[kg],
            "static_cap": owner_cap(m, kg),
            "bytes_vs_static": round(cap_by_kg[kg]
                                     / owner_cap(m, kg), 3),
            "probe_max": probe_max[kg], "worst_observed": worst[kg],
            "batches": BATCHES, "total_hits": tot_hits,
            "demoted": demoted[kg],
            "demotion_rate": (demoted[kg] / tot_hits
                              if tot_hits else 0.0),
        }))


if __name__ == "__main__":
    main()
