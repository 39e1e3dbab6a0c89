#!/usr/bin/env python
"""Partition quality -> halo traffic, measured. CPU-only: runs on an
8-device virtual CPU mesh.

On a planted-community graph (data/synthetic.streaming_power_law_graph
with ``communities``), compare GREEDY+refinement vs HASH partitions on:

* edge-cut fraction (the classic quality metric);
* the EXACT halo exchange's probed per-distance caps — which ARE the
  per-step remote-request volume — and the closed-form collective
  bytes/step they imply (utils/comm.halo_exact_{hop,fetch}_bytes);
* bytes per sampled edge through a few REAL partitioned train steps on
  the virtual CPU mesh (halo_overflow asserted zero).

This closes the loop the uniform-destination synthetic could not: cut
quality now has a measured traffic consequence (the reason XtraPulp
exists, ``prepare_dataset.sh:44``). One JSON line per partition mode.

CI-scale by default; --nodes 100000000 reproduces the at-scale
partitioner-quality datapoint in docs/ARCHITECTURE.md (generation is
cached under .bench_cache/).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench_cache")


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=200_000)
    ap.add_argument("--deg", type=int, default=8)
    ap.add_argument("--communities", type=int, default=64)
    ap.add_argument("--intra", type=float, default=0.8)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--fanouts", default="10,5")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--partition-only", action="store_true",
                    help="cut + probed caps only (no mesh training) — "
                         "for the 100M-node at-scale datapoint")
    args = ap.parse_args()
    fanouts = tuple(int(x) for x in args.fanouts.split(","))

    from legion.data.format import load_dataset
    from legion.data.synthetic import streaming_power_law_graph
    cache = os.path.join(
        CACHE_DIR, f"synth_clu_{args.nodes}_{args.deg}_"
        f"{args.communities}_{args.intra}")
    if not os.path.exists(os.path.join(cache, "meta.json")):
        t0 = time.time()
        streaming_power_law_graph(
            cache, num_nodes=args.nodes, avg_degree=args.deg,
            feature_dim=8, num_classes=16,
            train_num=min(args.nodes // 10, 800_000),
            valid_num=1000, test_num=1000,
            communities=args.communities, intra_frac=args.intra,
            log=log)
        log(f"generated in {time.time() - t0:.0f}s")
    data = load_dataset(cache, mmap=args.nodes > 10_000_000)

    from legion.config import (Config, DatasetConfig, ModelConfig,
                               SamplerConfig, TrainConfig)
    from legion.data.partition import edge_cut_fraction, partition_graph
    from legion.parallel.multihost import probe_dist_caps
    from legion.sampling.block import frontier_caps
    from legion.sampling.seeds import shard_node_set
    from legion.utils.comm import (halo_exact_fetch_bytes,
                                   halo_exact_hop_bytes)

    k, b = args.k, args.batch
    caps = frontier_caps(b, fanouts)
    chunk = 512 if args.nodes < 1_000_000 else 65536

    for mode in ("greedy", "hash"):
        t0 = time.time()
        part = partition_graph(data, k, mode=mode, chunk_size=chunk)
        t_part = time.time() - t0
        cut = edge_cut_fraction(data, part)
        shards = shard_node_set(np.asarray(data.train_ids), k, part)
        dcaps = probe_dist_caps(data.indptr, data.indices, part, shards,
                                fanouts, caps, k, b)
        # closed-form exact-exchange bytes per step (2 hops + fetch),
        # feature rows = 8 f32 cols here; per-edge normalization uses
        # the nominal sampled-edge count per step
        d = data.feature_dim
        step_bytes = (sum(halo_exact_hop_bytes(
            dcaps, f)["collective-permute"] for f in fanouts)
            + halo_exact_fetch_bytes(dcaps, d)["collective-permute"])
        rec = {"mode": mode, "k": k, "edge_cut": round(cut, 4),
               "partition_s": round(t_part, 1),
               "dist_caps": list(dcaps),
               "halo_bytes_per_step": step_bytes}

        if not args.partition_only:
            from legion.models import build_model
            from legion.parallel.multihost import (
                AXIS, make_partitioned_train_step)
            from legion.train.train_state import create_train_state
            from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
            import jax.numpy as jnp
            cfg = Config(
                dataset=DatasetConfig(num_classes=data.num_classes),
                sampler=SamplerConfig(fanouts=fanouts, batch_size=b),
                model=ModelConfig(arch="sage", hidden_dim=32,
                                  num_layers=2, dropout=0.0),
                train=TrainConfig(learning_rate=0.01, seed=0))
            model = build_model("sage", 32, data.num_classes, 2, 0.0)
            mesh = Mesh(np.array(jax.devices()[:k]), (AXIS,))
            pstep, put_shards = make_partitioned_train_step(
                cfg, model, caps, mesh, dist_caps=dcaps)
            shard_args = put_shards(data.indptr, data.indices,
                                    data.features, part)
            # params via dummy shapes
            from legion.train.partitioned_driver import _dummy_blocks
            x0 = jnp.zeros((caps[-1], data.feature_dim), jnp.float32)
            params = model.init(
                jax.random.PRNGKey(0),
                tuple(reversed(_dummy_blocks(caps, fanouts))), x0,
                deterministic=True)["params"]
            state = create_train_state(params, 0.01, 0)
            sh = NamedSharding(mesh, P(AXIS))
            rng = np.random.default_rng(0)
            nb = jax.device_put(np.full((k,), b, np.int32), sh)
            edges = ov = 0
            labels_all = np.asarray(data.labels)
            for i in range(args.steps):
                seeds_np = np.stack([
                    rng.permutation(s)[:b].astype(np.int32)
                    if len(s) >= b else
                    np.pad(np.asarray(s, np.int32), (0, b - len(s)),
                           constant_values=-1)
                    for s in shards])
                lab = np.where(seeds_np >= 0,
                               labels_all[np.clip(seeds_np, 0, None)],
                               -1).astype(np.int32)
                state, m = pstep(
                    state, *shard_args,
                    jax.device_put(seeds_np.reshape(-1), sh), nb,
                    jax.device_put(lab.reshape(-1), sh))
                edges += int(m["edges"])
                ov += int(m["halo_overflow"])
            rec["sampled_edges_per_step"] = edges // args.steps
            rec["halo_bytes_per_edge"] = round(
                step_bytes * k / max(edges / args.steps, 1), 2)
            rec["halo_overflow"] = ov
            assert ov == 0, f"halo overflow {ov} (raise slack)"
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
