"""Hybrid (device sub-CSR + host CSR) sampler: structural invariants,
true-edge checks, and hotness split accounting."""

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.hybrid import HybridSampler
from legion.cache.topo_cache import TopoCache
from legion.sampling.block import frontier_caps


def test_hybrid_sampler_end_to_end(small_graph):
    indptr = np.asarray(small_graph.indptr)
    indices = np.asarray(small_graph.indices)
    # cache the highest-degree 40% of nodes
    hot_order = np.argsort(-np.diff(indptr)).astype(np.int32)
    topo = TopoCache.build(indptr, indices, hot_order, capacity=800)

    b, fanouts = 48, (5, 4)
    caps = frontier_caps(b, fanouts)
    hs = HybridSampler(topo, indptr, indices, fanouts, caps)

    seeds_np = np.unique(np.asarray(small_graph.train_ids)[:b]).astype(np.int32)
    seeds = np.full((b,), -1, np.int32)
    seeds[:len(seeds_np)] = seeds_np
    batch = hs.sample_batch(jax.random.PRNGKey(0), jnp.asarray(seeds),
                            len(seeds_np), jnp.zeros((b,), jnp.int32),
                            host_seed=7)

    frontier = np.asarray(batch.frontier)
    nf = int(batch.num_frontier)
    assert (frontier[:nf] >= 0).all() and (frontier[nf:] == -1).all()
    assert len(set(frontier[:nf].tolist())) == nf

    # every valid edge decodes to a true graph edge regardless of the leg
    for blk in batch.blocks:
        pos = np.asarray(blk.nbr_pos)
        mask = np.asarray(blk.nbr_mask)
        for d in range(pos.shape[0]):
            for f in range(pos.shape[1]):
                if mask[d, f]:
                    dst_gid = frontier[d]
                    src_gid = frontier[pos[d, f]]
                    nbrs = indices[indptr[dst_gid]:indptr[dst_gid + 1]]
                    assert src_gid in nbrs

    # both legs exercised; stats metered
    assert hs.stats["hot"] > 0 and hs.stats["cold"] > 0
    assert 0.0 < hs.hot_fraction() < 1.0
    assert hs.stats["host_bytes"] > 0


def test_run_hybrid_training_end_to_end(small_graph):
    """Full host-topology driver: host presample -> cost model -> topo +
    feature caches -> hybrid-sampled training steps."""
    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, SamplerConfig, TrainConfig)
    from legion.train.hybrid_driver import run_hybrid_training
    cfg = Config(
        dataset=DatasetConfig(num_classes=int(small_graph.num_classes),
                              topology_placement="host",
                              feature_placement="host"),
        sampler=SamplerConfig(fanouts=(5, 4), batch_size=64,
                              eval_batch_size=32),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2),
        train=TrainConfig(epochs=1),
        cache=CacheConfig(enabled=True, budget_bytes=1 << 20,
                          presample_steps=3))
    res = run_hybrid_training(cfg, small_graph, log=lambda s: None)
    h = res["history"][-1]
    assert np.isfinite(h["loss"])
    assert 0.0 < h["feat_hit_rate"] <= 1.0
    assert 0.0 <= h["topo_hot_fraction"] <= 1.0


def _hybrid_cfg(small_graph, epochs=2, ck=None, every=0):
    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, SamplerConfig, TrainConfig)
    return Config(
        dataset=DatasetConfig(num_classes=int(small_graph.num_classes),
                              topology_placement="host",
                              feature_placement="host"),
        sampler=SamplerConfig(fanouts=(5, 4), batch_size=64,
                              eval_batch_size=32),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(epochs=epochs, learning_rate=0.01,
                          checkpoint_dir=ck, checkpoint_every_steps=every),
        cache=CacheConfig(enabled=True, budget_bytes=1 << 20,
                          presample_steps=3))


def test_hybrid_driver_eval_and_fetch_budget(small_graph):
    """VERDICT item 3: the hybrid driver reports Val/Test accuracy, and
    the pipelined trainer spends H packed device->host fetches per step
    (vs 2H+1 for the naive per-hop hit+frontier+plan fetches)."""
    from legion.train.hybrid_driver import run_hybrid_training
    res = run_hybrid_training(_hybrid_cfg(small_graph), small_graph,
                              log=lambda s: None)
    chance = 1.0 / small_graph.num_classes
    assert res["history"][-1]["valid"] > 1.5 * chance
    assert res["test_acc"] > 1.5 * chance
    assert res["history"][1]["loss"] < res["history"][0]["loss"]

    # transfer accounting: H fetches per train step + 1 epoch prologue;
    # eval_epoch spends the same per-step budget
    h0 = res["history"][0]
    hops = 2
    train_steps = h0["steps"]
    assert h0["fetches"] == hops * train_steps + 1, h0
    naive = (2 * hops + 1) * train_steps
    assert naive / h0["fetches"] >= 2.0
    # per-EPOCH metering: later epochs must report their own deltas, not
    # the trainer-lifetime totals (which also accumulate eval epochs)
    for h in res["history"][1:]:
        assert h["fetches"] == hops * h["steps"] + 1, h
        assert 0.0 <= h["topo_hot_fraction"] <= 1.0


def test_hybrid_eval_fetch_budget(small_graph):
    """Eval spends the same H-fetches-per-step budget as training (its
    cross-batch overlap structure is shared with run_epoch): batch t+1's
    hop-0 is computed inside batch t's finish program, so the host legs
    overlap device eval — no extra round-trips."""
    from legion.train.hybrid_driver import run_hybrid_training
    res = run_hybrid_training(_hybrid_cfg(small_graph, epochs=1),
                              small_graph, log=lambda s: None)
    tr = res["trainer"]
    ids = np.asarray(small_graph.valid_ids)[:48]
    seeds = np.full((3, 64), -1, np.int32)
    counts = np.zeros((3,), np.int32)
    for t in range(3):
        chunk = ids[t * 16:(t + 1) * 16]
        seeds[t, : len(chunk)] = chunk
        counts[t] = len(chunk)
    labels = np.where(seeds >= 0,
                      np.asarray(small_graph.labels)[np.clip(seeds, 0, None)],
                      -1).astype(np.int32)
    f0 = tr.stats["fetches"]
    acc = tr.eval_epoch(res["state"].params, seeds, counts, labels)
    assert 0.0 <= acc <= 1.0
    hops = 2
    assert tr.stats["fetches"] - f0 == hops * 3 + 1


def test_hybrid_driver_kill_and_resume(small_graph, tmp_path):
    from legion.train.hybrid_driver import run_hybrid_training
    from legion.train.train_state import latest_checkpoint
    ck = str(tmp_path / "ck")
    run_hybrid_training(_hybrid_cfg(small_graph, epochs=1, ck=ck, every=2),
                        small_graph, log=lambda s: None)
    assert latest_checkpoint(ck) is not None
    logs = []
    res = run_hybrid_training(_hybrid_cfg(small_graph, epochs=2, ck=ck),
                              small_graph, log=logs.append)
    assert any("resumed from checkpoint" in l for l in logs)
    assert [r["epoch"] for r in res["history"]] == [1]
