"""End-to-end edge-partitioned multi-host training on the virtual mesh:
8 'hosts', no host holds the full graph/features; loss must fall."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
from legion.data.partition import partition_graph
from legion.models import build_model
from legion.parallel.multihost import make_partitioned_train_step
from legion.sampling.block import frontier_caps
from legion.sampling.seeds import shard_node_set
from legion.train.train_state import create_train_state

K = 8


def test_partitioned_training_learns(small_graph):
    mesh = Mesh(np.array(jax.devices()[:K]), ("data",))
    b, fanouts = 32, (4, 3)
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=fanouts, batch_size=b),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0),
    )
    caps = frontier_caps(b, fanouts)
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)

    part = partition_graph(small_graph, K, mode="greedy")
    # exact halo exchange (production default) at loose per-distance
    # caps: learning must go through the ppermute path
    step, put_shards = make_partitioned_train_step(
        cfg, model, caps, mesh, dist_caps=(caps[-1],) * (K - 1))
    owned, sp, si, fr, owner = put_shards(
        small_graph.indptr, small_graph.indices, small_graph.features,
        part)

    # params init on a dummy single-host batch shape
    x0 = jnp.zeros((caps[-1], small_graph.feature_dim), jnp.float32)
    from legion.sampling.sampler import DeviceGraph, sample_batch
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    batch0 = sample_batch(jax.random.PRNGKey(0), g,
                          jnp.arange(b, dtype=jnp.int32),
                          jnp.full((), b, jnp.int32),
                          jnp.zeros((b,), jnp.int32), fanouts, caps)
    params = model.init(jax.random.PRNGKey(0),
                        tuple(reversed(batch0.blocks)), x0,
                        deterministic=True)["params"]
    state = create_train_state(params, cfg.train.learning_rate, 0)

    # per-host seed shards from the partition (the reference's
    # partition-file path, src/GPUGraphStore.cu:332-343)
    shards = shard_node_set(np.asarray(small_graph.train_ids), K, part)
    labels_all = np.asarray(small_graph.labels)
    sh = NamedSharding(mesh, P("data"))
    nb = jax.device_put(jnp.full((K,), b, jnp.int32), sh)

    losses = []
    rng = np.random.default_rng(0)
    for it in range(6):
        seeds_np = np.stack([
            rng.permutation(s)[:b].astype(np.int32) if len(s) >= b
            else np.pad(s, (0, b - len(s)), constant_values=-1)
            for s in shards])
        lab_np = np.where(seeds_np >= 0,
                          labels_all[np.clip(seeds_np, 0, None)], -1)
        seeds = jax.device_put(jnp.asarray(seeds_np.reshape(-1)), sh)
        labels = jax.device_put(jnp.asarray(lab_np.reshape(-1)
                                            .astype(np.int32)), sh)
        state, m = step(state, owned, sp, si, fr, owner, seeds, nb,
                        labels)
        losses.append(float(m["loss"]))
        assert int(m["edges"]) > 0
        assert int(m["halo_overflow"]) == 0

    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_put_shards_distributed_matches_build(small_graph):
    """Per-process loading (jax.distributed scaffolding) assembles
    exactly the arrays the single-process put_shards builds."""
    from legion.parallel.halo import HostShard
    from legion.parallel.launch import (local_part_ids,
                                        put_shards_distributed)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    part = partition_graph(small_graph, 4, mode="greedy")

    assert local_part_ids(mesh) == [0, 1, 2, 3]  # single process: all

    got = put_shards_distributed(small_graph.indptr, small_graph.indices,
                                 small_graph.features, part, mesh)
    parts = HostShard.build(small_graph.indptr, small_graph.indices,
                            small_graph.features, part, 4)
    for i in range(4):
        expect = np.stack([p[i] for p in parts])
        np.testing.assert_array_equal(np.asarray(got[i]), expect)

    rows, edges = HostShard.part_shapes(small_graph.indptr, part, 4)
    assert int(rows.sum()) == small_graph.num_nodes
    assert int(edges.sum()) == len(np.asarray(small_graph.indices))


def test_partitioned_lifecycle_and_resume(small_graph, tmp_path):
    """run_partitioned_training: multi-epoch fit on the virtual mesh
    with Val/Test accuracy and checkpoint resume (SURVEY §7 step 7)."""
    from legion.train.partitioned_driver import run_partitioned_training
    from legion.config import ParallelConfig

    def mk(epochs):
        return Config(
            dataset=DatasetConfig(num_classes=small_graph.num_classes),
            sampler=SamplerConfig(fanouts=(4, 3), batch_size=32,
                                  eval_batch_size=64),
            model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                              dropout=0.0),
            train=TrainConfig(learning_rate=0.01, seed=0, epochs=epochs,
                              checkpoint_dir=str(tmp_path / "ck")),
            parallel=ParallelConfig(num_devices=4))

    out = run_partitioned_training(mk(2), small_graph, log=lambda s: None)
    assert out["mesh"] == {"data": 4}
    assert 0.0 <= out["edge_cut"] < 1.0
    assert out["history"][1]["loss"] < out["history"][0]["loss"]
    chance = 1.0 / small_graph.num_classes
    assert out["history"][-1]["valid"] > 1.5 * chance
    assert out["test_acc"] > 1.5 * chance

    logs = []
    out2 = run_partitioned_training(mk(3), small_graph, log=logs.append)
    assert any("resumed from checkpoint" in l for l in logs)
    assert [r["epoch"] for r in out2["history"]] == [2]


def test_partitioned_within_bound_of_dp(small_graph):
    """Scaling guard: the partitioned step's edges/s
    must stay within a (loose, CPU-timing-tolerant) factor of the DP
    step's at 4 devices. Catches structural regressions — e.g. a
    collective accidentally serialized per hop. Measured ratio on the
    virtual mesh is ~0.9 (docs/ARCHITECTURE.md scaling table)."""
    import time

    from legion.parallel.dp import make_dp_train_step
    from legion.parallel.mesh import make_mesh
    from legion.sampling.sampler import DeviceGraph, sample_batch

    k, b, fanouts = 4, 64, (4, 3)
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=fanouts, batch_size=b),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0),
    )
    caps = frontier_caps(b, fanouts)
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    feats = jnp.asarray(np.asarray(small_graph.features))
    batch0 = sample_batch(jax.random.PRNGKey(0), g,
                          jnp.arange(b, dtype=jnp.int32),
                          jnp.full((), b, jnp.int32),
                          jnp.zeros((b,), jnp.int32), fanouts, caps)
    x0 = jnp.zeros((caps[-1], small_graph.feature_dim), jnp.float32)
    params = model.init(jax.random.PRNGKey(0),
                        tuple(reversed(batch0.blocks)), x0,
                        deterministic=True)["params"]

    ids = np.asarray(small_graph.train_ids)
    seeds_np = np.random.default_rng(0).permutation(ids)[: k * b].astype(
        np.int32)
    labels_np = np.asarray(small_graph.labels)[seeds_np].astype(np.int32)

    class Timed:
        """One step program: compiled and warmed on construction; each
        ``step()`` times one step per sampled edge, keeping the best."""

        def __init__(self, step_fn, args):
            self.fn, self.args, self.best = step_fn, args, np.inf
            self.st = create_train_state(
                jax.tree_util.tree_map(jnp.copy, params), 0.01, 0)
            self.st, m = step_fn(self.st, *args)   # compile + warm
            _ = float(m["loss"])

        def step(self):
            t0 = time.perf_counter()
            self.st, m = self.fn(self.st, *self.args)
            e = float(m["edges"]); _ = float(m["loss"])
            self.best = min(self.best, (time.perf_counter() - t0) / e)

        @property
        def rate(self):
            return 1.0 / self.best

    dmesh = make_mesh(k, cache_group_size=1)
    dsh = NamedSharding(dmesh, P(("data", "cache")))
    dstep, _ = make_dp_train_step(cfg, model, caps, dmesh)
    dstep_t = Timed(dstep, (g, feats, jax.device_put(seeds_np, dsh),
                            jnp.full((), b, jnp.int32),
                            jax.device_put(labels_np, dsh)))

    pmesh = Mesh(np.array(jax.devices()[:k]), ("data",))
    part = partition_graph(small_graph, k, mode="greedy")
    pstep, put_shards = make_partitioned_train_step(
        cfg, model, caps, pmesh, dist_caps=(caps[-1],) * (k - 1))
    shard_args = put_shards(small_graph.indptr, small_graph.indices,
                            small_graph.features, part)
    psh = NamedSharding(pmesh, P("data"))
    pstep_t = Timed(pstep, (*shard_args,
                            jax.device_put(seeds_np, psh),
                            jax.device_put(np.full((k,), b, np.int32),
                                           psh),
                            jax.device_put(labels_np, psh)))
    # the two programs' steps alternate, so a burst of load from other
    # processes on the host slows both rather than one
    for _i in range(5):
        dstep_t.step()
        pstep_t.step()

    assert pstep_t.rate > 0.25 * dstep_t.rate, (pstep_t.rate,
                                              dstep_t.rate)


def test_partitioned_uses_precomputed_partition(small_graph, tmp_path):
    """A dataset carrying a k-way partition file (the reference's
    XtraPulp partition_<k>_bn, src/GPUGraphStore.cu:324-339) is used
    verbatim instead of re-partitioning."""
    import dataclasses as _dc

    from legion.config import (Config, DatasetConfig, ModelConfig,
                               ParallelConfig, SamplerConfig,
                               TrainConfig)
    from legion.train.partitioned_driver import run_partitioned_training
    part = partition_graph(small_graph, 4, mode="hash")
    data = _dc.replace(small_graph, partition=part) if _dc.is_dataclass(
        small_graph) else small_graph._replace(partition=part)
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32,
                              eval_batch_size=64),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0, epochs=1),
        parallel=ParallelConfig(num_devices=4))
    logs = []
    out = run_partitioned_training(cfg, data, log=logs.append)
    assert any("precomputed 4-way partition" in l for l in logs), logs
    assert np.isfinite(out["history"][0]["loss"])


def test_two_process_launch_matches_single_process(small_graph):
    """The jax.distributed launch path as 2 REAL processes (VERDICT r2
    missing #2): spawn two workers (2 CPU devices each) joined via a
    localhost coordinator, run run_partitioned_training for 1 epoch, and
    check both exit 0 with the same metrics as the identical program on
    a single-process 4-device mesh. Proves the process-boundary code:
    make_array_from_process_local_data assembly, coordinator wiring,
    device->partition assignment (parallel/launch.py)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "mp_partitioned_worker.py")
    port = 29500 + (os.getpid() % 500)
    env = dict(os.environ,
               LEGION_COORDINATOR=f"localhost:{port}",
               LEGION_NUM_PROCESSES="2",
               LEGION_MP_CPU_DEVICES="2")
    env.pop("LEGION_PROCESS_ID", None)
    procs = [subprocess.Popen([sys.executable, worker, str(pid)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=repo)
             for pid in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{se[-3000:]}"
    recs = []
    for so, _ in outs:
        line = [l for l in so.splitlines() if l.startswith("MPRESULT ")]
        assert line, so[-2000:]
        recs.append(json.loads(line[0][len("MPRESULT "):]))
    for r in recs:
        assert r["processes"] == 2 and r["devices"] == 4
        assert r["mesh"] == {"data": 4}
    # both processes observe identical (replicated) metrics
    assert recs[0]["loss"] == recs[1]["loss"]
    assert recs[0]["valid"] == recs[1]["valid"]

    # single-process reference: SAME program on a 4-device mesh
    from legion.config import (CacheConfig, ParallelConfig)
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
        parallel=ParallelConfig(num_devices=4))
    ref = run_partitioned_training(cfg, data, log=lambda s: None)
    # identical program, different process topology: losses match (only
    # cross-process reduction order may perturb the last few ulps)
    np.testing.assert_allclose(recs[0]["loss"],
                               ref["history"][0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(recs[0]["mean_loss"],
                               ref["history"][0]["mean_loss"], rtol=1e-5)
    np.testing.assert_allclose(recs[0]["valid"],
                               ref["history"][0]["valid"], rtol=1e-6)
    np.testing.assert_allclose(recs[0]["test_acc"], ref["test_acc"],
                               rtol=1e-6)


def test_probe_covers_eval_seed_composition(small_graph):
    """The exact-halo cap probe must cover every seed COMPOSITION the
    one cap set serves (r5 review finding): valid/test sets can
    concentrate on partition-boundary nodes with a different
    per-distance skew than train seeds. The driver probes train + valid
    + test shard compositions and takes the element-wise max; eval must
    run with zero halo overflow even for an adversarial valid set."""
    import dataclasses
    import re

    from legion.config import ParallelConfig
    from legion.parallel.multihost import probe_dist_caps_batches
    from legion.sampling.seeds import epoch_eval_seeds, shard_node_set
    from legion.train.partitioned_driver import run_partitioned_training

    k = 4
    part = partition_graph(small_graph, k, mode="greedy")
    # adversarial valid set: the partition-0 nodes with the LARGEST
    # remote in-neighborhoods (their hop requests skew hardest across
    # the ring, unlike the spread-out train shards)
    indptr = np.asarray(small_graph.indptr)
    indices = np.asarray(small_graph.indices)
    remote_deg = np.zeros(small_graph.num_nodes, np.int64)
    for v in np.nonzero(part == 0)[0]:
        nb = indices[indptr[v]:indptr[v + 1]]
        remote_deg[v] = int((part[nb] != 0).sum())
    adversarial = np.argsort(-remote_deg)[:64].astype(np.int32)
    data = dataclasses.replace(small_graph, valid_ids=adversarial)

    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32,
                              eval_batch_size=32),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0, epochs=1),
        parallel=ParallelConfig(num_devices=k, halo_cap_slack=1.05,
                                halo_probe_batches=2))

    events = []
    from legion.utils import logging as tlog
    orig = tlog.log_metrics
    tlog.log_metrics = lambda m, **kw: events.append(m)
    try:
        logs = []
        out = run_partitioned_training(cfg, data, log=logs.append)
    finally:
        tlog.log_metrics = orig

    # no eval (or train) halo overflow despite the adversarial valid set
    drops = [e for e in events if e.get("event") == "halo_overflow"]
    assert not drops, drops
    assert np.isfinite(out["history"][-1]["valid"])

    # and the driver's caps must dominate a probe of the ACTUAL eval
    # chunks (the deterministic epoch_eval_seeds schedule — what eval
    # runs; the pre-fix behavior probed random train-shard subsets only)
    m = [re.search(r"per-distance caps \(([\d, ]+)\)", l)
         for l in logs]
    driver_caps = next(tuple(int(x) for x in g.group(1).split(","))
                       for g in m if g)
    caps = frontier_caps(32, (4, 3))
    eshards = shard_node_set(adversarial, k, part)
    steps_e = (max(max(len(s) for s in eshards), 1) - 1) // 32 + 1
    per = tuple((len(s) - 1) // steps_e + 1 if len(s) else 0
                for s in eshards)
    seeds_e, _ = epoch_eval_seeds(eshards, steps_e, per, 32)
    vcaps = probe_dist_caps_batches(
        data.indptr, data.indices, part,
        [(i, seeds_e[i, t]) for t in range(steps_e) for i in range(k)],
        (4, 3), caps, k, slack=1.05, seed=0)
    assert all(d >= v for d, v in zip(driver_caps, vcaps)), (
        driver_caps, vcaps)
