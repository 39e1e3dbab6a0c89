#!/usr/bin/env python
"""papers100M-scale smoke: the reference's headline dataset class run
end-to-end on ONE GPU (registry entry PA: 111M nodes / ~1.6B edges,
``legion_server.py:14-21``).

What this validates that products-scale benches cannot:
* node ids >= 2^24 — beyond what a float lane select holds exactly
  (the sampler's integer lane gather must stay exact);
* the aligned-layout HBM guard: at avg degree ~14 the 64-lane padding
  would need >2^31 lanes, so from_host must fall back to the windowed
  layout (products keeps aligned);
* device CSR near the int32-addressing edge (~6.2 GB indices in HBM)
  with host-resident features behind the hotness cache (feature table
  >> HBM budget: 111M rows vs a 1 GB bf16 cache).

Run:  python tools/smoke_pa_scale.py [epoch_steps=10]
The 21 GB generated dataset is cached under .bench_cache/synth_pa.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

STEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 10
BATCH = 8000
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CACHE = os.path.join(ROOT, ".bench_cache", "synth_pa")


def load_or_gen():
    from legion.data.format import load_dataset, save_dataset
    if os.path.exists(os.path.join(CACHE, "meta.json")):
        t0 = time.time()
        data = load_dataset(CACHE, mmap=True)
        print(f"PA graph loaded (mmap) {time.time()-t0:.0f}s", flush=True)
        return data
    from legion.data.synthetic import bench_graph
    t0 = time.time()
    data = bench_graph(num_nodes=111_059_956, avg_degree=14,
                       feature_dim=32, num_classes=172, train_frac=0.002)
    print(f"PA graph generated {time.time()-t0:.0f}s "
          f"({data.num_edges} edges)", flush=True)
    save_dataset(data, CACHE)
    print("saved to cache", flush=True)
    return data


def main():
    import dataclasses

    from legion.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    data = load_or_gen()
    # trim the seed sets so one epoch is STEPS steps (scale validation,
    # not a convergence run)
    data = dataclasses.replace(
        data,
        train_ids=np.asarray(data.train_ids)[: STEPS * BATCH],
        valid_ids=np.asarray(data.valid_ids)[: 2 * BATCH],
        test_ids=np.asarray(data.test_ids)[: 2 * BATCH])

    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, SamplerConfig, TrainConfig)
    from legion.train.cached_driver import run_cached_training

    # layout/coverage preconditions checked from numpy shapes — a
    # throwaway DeviceGraph here would copy ~7GB to the device for
    # nothing (run_cached_training builds its own)
    deg = np.diff(np.asarray(data.indptr))
    pad_lanes = int(np.where(deg == 0, 0,
                             np.where(deg <= 64, 64,
                                      (deg + 127) // 128 * 128)).sum())
    assert pad_lanes > 2.0 * data.num_edges or pad_lanes >= 2 ** 31, \
        "expected the aligned layout to fall back to windowed at PA degree"
    assert data.num_nodes >= (1 << 24), "big-id select must be exercised"

    cfg = Config(
        dataset=DatasetConfig(name="synthetic-PA", num_classes=172,
                              feature_placement="host"),
        sampler=SamplerConfig(fanouts=(25, 10), batch_size=BATCH,
                              dedup_last=True),
        model=ModelConfig(arch="sage", hidden_dim=256, num_layers=2,
                          dropout=0.5, dtype="bfloat16"),
        train=TrainConfig(learning_rate=0.003, epochs=1),
        cache=CacheConfig(enabled=True, budget_bytes=1 << 30,
                          presample_steps=6),
    )
    t0 = time.time()
    res = run_cached_training(cfg, data)
    h = res["history"][-1]
    print(f"PA-scale smoke OK: total {time.time()-t0:.0f}s, "
          f"{h['steps']} steps x {h['seconds']/h['steps']*1e3:.0f} ms, "
          f"hit {h['cache_hit_rate']:.3f}, host_gb {h['host_gb']:.2f}, "
          f"loss {h['loss']:.3f}", flush=True)


if __name__ == "__main__":
    main()
