#!/usr/bin/env python
"""uk-union-scale smoke: the reference's BILLION-edge host-topology
configuration (registry UKS: 133.6M nodes / 5.5B edges,
``legion_server.py:30-35``) run end-to-end on ONE GPU through the
public hybrid driver — host CSR beyond 2^31 edges (int64 addressing in
the C++ sampler and every cache-build path), HBM hot sub-CSR + striped
feature cache from the cost model, threaded host sampling for cold
frontier nodes, host-staged feature misses.

What this validates that the PA-scale smoke cannot:
* >2^31-edge host CSR: every indptr value past edge 2^31 is int64
  end-to-end (memmap'd 22GB indices file, C++ sampler, TopoCache.build
  gathers, presampling);
* the hybrid (host-topology) path itself at its design scale — the
  PA smoke exercises the DEVICE-CSR cached path;
* staging/caps sizing under real billion-scale miss volumes.

Run:  python tools/smoke_uk_scale.py [epoch_steps=6]
      python tools/smoke_uk_scale.py --mesh   # + ONE striped-hybrid
                                    step on the 8-device virtual CPU
                                    mesh at this scale (tiny batch)
The ~40GB dataset is generated once into .bench_cache/synth_uk
(generation time grows with the host's cores; features are narrow — dim 32 — per the
smoke's scope: topology scale is what's under test).
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CACHE = os.path.join(ROOT, ".bench_cache", "synth_uk")

NODES = 133_633_040            # uk-union row count (legion_server.py:30)
AVG_DEG = 41.3                 # ~5.52B edges (uk-union: 5.51B)
BATCH = 8000

MESH = "--mesh" in sys.argv
ARGS = [a for a in sys.argv[1:] if not a.startswith("-")]
STEPS = int(ARGS[0]) if ARGS else 6


def load_or_gen():
    from legion.data.format import load_dataset
    from legion.data.synthetic import streaming_power_law_graph
    if not os.path.exists(os.path.join(CACHE, "meta.json")):
        streaming_power_law_graph(
            CACHE, num_nodes=NODES, avg_degree=AVG_DEG, feature_dim=32,
            num_classes=100, seed=7,
            train_num=max(STEPS, 20) * BATCH, valid_num=2 * BATCH,
            test_num=2 * BATCH)
    t0 = time.time()
    data = load_dataset(CACHE, mmap=True)
    print(f"UK graph loaded (mmap) {time.time()-t0:.0f}s: "
          f"{data.num_nodes} nodes / {data.num_edges} edges", flush=True)
    assert data.num_edges > 2 ** 31, "smoke must cross int32 edge count"
    return data


def main():
    import numpy as np

    import jax
    from legion.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    data = load_or_gen()
    data = dataclasses.replace(
        data,
        train_ids=np.asarray(data.train_ids)[: STEPS * BATCH],
        valid_ids=np.asarray(data.valid_ids)[: BATCH],
        test_ids=np.asarray(data.test_ids)[: BATCH])

    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, SamplerConfig, TrainConfig)

    cfg = Config(
        dataset=DatasetConfig(name="synthetic-UKS", num_classes=100,
                              feature_placement="host",
                              topology_placement="host"),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=BATCH,
                              eval_batch_size=BATCH, dedup_last=True),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003, epochs=1),
        cache=CacheConfig(enabled=True, budget_bytes=2 << 30,
                          presample_steps=3),
    )

    if MESH:
        # striped-hybrid at uk scale on the virtual CPU mesh: tiny batch,
        # one epoch of 2 steps — validates the multi-chip host-topology
        # program (striped hot sub-CSR + striped features + host sampler)
        # against the >2^31-edge CSR without chips
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
        cfg = dataclasses.replace(
            cfg,
            sampler=SamplerConfig(fanouts=(5, 4), batch_size=64,
                                  eval_batch_size=64, dedup_last=True),
            model=ModelConfig(arch="sage", hidden_dim=32, num_layers=2,
                              dtype="float32"),
            cache=CacheConfig(enabled=True, budget_bytes=256 << 20,
                              presample_steps=2),
            train=TrainConfig(learning_rate=0.003, epochs=1),
        )
        import legion.config as _c
        from legion.train.striped_hybrid_driver import (
            run_striped_hybrid_training)
        cfg = dataclasses.replace(
            cfg, parallel=_c.ParallelConfig(num_devices=8),
            cache=dataclasses.replace(cfg.cache, group_size=2))
        data = dataclasses.replace(
            data, train_ids=np.asarray(data.train_ids)[: 2 * 8 * 64],
            valid_ids=np.asarray(data.valid_ids)[: 8 * 64],
            test_ids=np.asarray(data.test_ids)[: 8 * 64])
        t0 = time.time()
        res = run_striped_hybrid_training(cfg, data)
        h = res["history"][-1]
        print(f"UK-scale striped-hybrid mesh smoke OK: "
              f"{time.time()-t0:.0f}s, loss {h['loss']:.3f}, "
              f"topo_hot {h['topo_hot_fraction']:.3f}", flush=True)
        return

    from legion.train.hybrid_driver import run_hybrid_training
    t0 = time.time()
    res = run_hybrid_training(cfg, data)
    h = res["history"][-1]
    print(f"UK-scale smoke OK: total {time.time()-t0:.0f}s, "
          f"{h['steps']} steps x {h['seconds']/h['steps']*1e3:.0f} ms, "
          f"feat_hit {h['feat_hit_rate']:.3f}, "
          f"topo_hot {h['topo_hot_fraction']:.3f}, "
          f"host_feat_gb {h['host_feat_gb']:.2f}, "
          f"host_topo_gb {h['host_topo_gb']:.3f}, "
          f"loss {h['loss']:.3f}", flush=True)


if __name__ == "__main__":
    main()
