"""Worker process for the 2-process launch test (test_multihost.py).

Run as: python mp_partitioned_worker.py <process_id>
with LEGION_COORDINATOR / LEGION_NUM_PROCESSES / LEGION_MP_CPU_DEVICES
set. Builds the SAME deterministic synthetic graph in every process,
runs run_partitioned_training for 1 epoch through the real
jax.distributed launch path (parallel.launch), and prints the history
as one sentinel-prefixed JSON line for the parent to compare against a
single-process run of the identical program.

jax multi-process-CPU caveats this path depends on (verified here):
* the CPU platform + per-process device count must be set via
  jax.config BEFORE jax.distributed.initialize;
* cross-process CPU collectives ride a Gloo backend that
  jax.distributed wires up automatically;
* jax.device_put of a host numpy array onto a sharding spanning
  non-addressable devices works when every process passes the same
  array (the driver relies on this for seeds/labels).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices",
                  int(os.environ.get("LEGION_MP_CPU_DEVICES", "2")))

os.environ["LEGION_PROCESS_ID"] = sys.argv[1]


def main():
    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, ParallelConfig,
                               SamplerConfig, TrainConfig)
    from legion.data.synthetic import random_power_law_graph
    from legion.train.partitioned_driver import run_partitioned_training

    data = random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)
    cfg = Config(
        dataset=DatasetConfig(num_classes=7),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32,
                              eval_batch_size=32, probe_caps=False),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0, epochs=1),
        cache=CacheConfig(),
        parallel=ParallelConfig(num_devices=0))
    out = run_partitioned_training(cfg, data, log=lambda s: None)
    rec = {"pid": int(sys.argv[1]),
           "processes": jax.process_count(),
           "devices": len(jax.devices()),
           "mesh": out["mesh"],
           "loss": out["history"][0]["loss"],
           "mean_loss": out["history"][0]["mean_loss"],
           "valid": out["history"][0]["valid"],
           "test_acc": out["test_acc"]}
    print("MPRESULT " + json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
