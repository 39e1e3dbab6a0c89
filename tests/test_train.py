"""End-to-end training: loss decreases and accuracy beats chance on a
planted-label synthetic graph (the reference's implicit correctness test
is downstream accuracy, SURVEY.md §4)."""

import numpy as np

from legion.config import (Config, DatasetConfig, ModelConfig,
                           SamplerConfig, TrainConfig)
from legion.train.loop import Trainer


def _cfg(num_classes, arch="sage", batch=128):
    return Config(
        dataset=DatasetConfig(num_classes=num_classes),
        sampler=SamplerConfig(fanouts=(5, 5), batch_size=batch,
                              eval_batch_size=128),
        model=ModelConfig(arch=arch, hidden_dim=32, num_layers=2, dropout=0.2),
        train=TrainConfig(learning_rate=0.01, epochs=3, seed=0),
    )


def test_sage_learns(small_graph):
    tr = Trainer(_cfg(small_graph.num_classes), small_graph)
    first = tr.train_one_epoch(0)
    for e in range(1, 3):
        rec = tr.train_one_epoch(e)
    assert rec["mean_loss"] < first["mean_loss"]
    acc = tr.evaluate("valid")
    assert acc > 2.0 / small_graph.num_classes, f"acc {acc} is chance-level"


def test_gcn_trains(small_graph):
    tr = Trainer(_cfg(small_graph.num_classes, arch="gcn"), small_graph)
    first = tr.train_one_epoch(0)
    rec = tr.train_one_epoch(1)
    assert np.isfinite(rec["mean_loss"])
    assert rec["mean_loss"] < first["mean_loss"] * 1.2


def test_lp_sage_trains(small_graph):
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=(5, 5), batch_size=129,
                              eval_batch_size=129),
        model=ModelConfig(arch="lp_sage", hidden_dim=32, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, epochs=2, seed=0),
    )
    tr = Trainer(cfg, small_graph)
    first = tr.train_one_epoch(0)
    rec = tr.train_one_epoch(1)
    assert np.isfinite(rec["mean_loss"])
    assert rec["mean_loss"] < first["mean_loss"]


def test_checkpoint_roundtrip(small_graph, tmp_path):
    import jax
    import jax.numpy as jnp
    cfg = _cfg(small_graph.num_classes)
    cfg = Config(dataset=cfg.dataset, sampler=cfg.sampler, model=cfg.model,
                 train=TrainConfig(learning_rate=0.01, epochs=1, seed=0,
                                   checkpoint_dir=str(tmp_path / "ckpt")))
    tr = Trainer(cfg, small_graph)
    tr.train_one_epoch(0)
    from legion.train.train_state import restore_checkpoint, save_checkpoint
    save_checkpoint(cfg.train.checkpoint_dir, tr.state)

    tr2 = Trainer(cfg, small_graph)  # restores in __init__
    assert int(tr2.state.step) == int(tr.state.step)
    a = jax.tree_util.tree_leaves(tr.state.params)
    b = jax.tree_util.tree_leaves(tr2.state.params)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_trainer_cap_probe(small_graph):
    """Probing tightens caps below the loose bound and training still
    runs (probe gate forced on via min_cap=0)."""
    import dataclasses
    from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
    from legion.sampling.block import frontier_caps
    from legion.train.loop import Trainer
    cfg = Config(
        dataset=DatasetConfig(num_classes=int(small_graph.num_classes)),
        sampler=SamplerConfig(fanouts=(8, 8), batch_size=64,
                              eval_batch_size=32, probe_caps=True,
                              probe_caps_min_cap=0),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2),
        train=TrainConfig(epochs=1))
    tr = Trainer(cfg, small_graph)
    loose = frontier_caps(64, (8, 8))
    assert tr.caps[1] <= loose[1]
    assert tr.caps[-1] == tr.caps[-2] * 9   # identity-append extent
    rec = tr.train_one_epoch(0)
    assert np.isfinite(rec["loss"])


def test_trainer_three_hop(small_graph):
    """3-hop sampling + 3-layer model end to end (fanouts generalize)."""
    from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
    from legion.train.loop import Trainer
    cfg = Config(
        dataset=DatasetConfig(num_classes=int(small_graph.num_classes)),
        sampler=SamplerConfig(fanouts=(4, 3, 2), batch_size=32,
                              eval_batch_size=16),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=3),
        train=TrainConfig(epochs=1))
    tr = Trainer(cfg, small_graph)
    rec = tr.train_one_epoch(0)
    acc = tr.evaluate("valid")
    assert np.isfinite(rec["loss"]) and 0.0 <= acc <= 1.0


def test_cap_overflow_metric_fires(small_graph):
    """Deliberately undersized frontier caps must be REPORTED via the
    cap_overflow metric (silently thinned neighborhoods are the failure
    mode the guard exists for)."""
    import jax
    import jax.numpy as jnp
    from legion.config import (Config, DatasetConfig, ModelConfig,
                               SamplerConfig, TrainConfig)
    from legion.data.format import pad_feature_dim
    from legion.models import build_model
    from legion.sampling.sampler import DeviceGraph, gather_features, sample_batch
    from legion.train.loop import make_step_fns
    from legion.train.train_state import create_train_state

    b = 64
    cfg = Config(dataset=DatasetConfig(num_classes=small_graph.num_classes),
                 sampler=SamplerConfig(fanouts=(8, 4), batch_size=b,
                                       dedup_last=False),
                 model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                                   dropout=0.0),
                 train=TrainConfig(learning_rate=0.01))
    # hop-1 cap too small to hold the realized uniques; last cap exact
    caps = (b, b + 16, (b + 16) * 5)
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)
    graph = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    feats = jnp.asarray(pad_feature_dim(
        np.asarray(small_graph.features, np.float32), 1))
    seeds = jnp.asarray(np.arange(b, dtype=np.int32))
    labels = jnp.zeros((b,), jnp.int32)
    batch = sample_batch(jax.random.PRNGKey(0), graph, seeds,
                         jnp.full((), b, jnp.int32), labels, (8, 4), caps,
                         dedup_last=False)
    x = gather_features(feats, batch.frontier)
    params = model.init(jax.random.PRNGKey(0),
                        tuple(reversed(batch.blocks)), x,
                        deterministic=True)["params"]
    state = create_train_state(params, 0.01, 0)
    fns = make_step_fns(cfg, model, caps)
    _, metrics = jax.jit(fns.train_step)(
        state, graph, feats, seeds, jnp.full((), b, jnp.int32), labels)
    assert int(metrics["cap_overflow"]) > 0


def test_sage_accuracy_regression_bound(small_graph):
    """Pinned accuracy bound (not just beats-chance): the reference's
    implicit correctness test is downstream accuracy (SURVEY.md §4);
    until OGB data is mountable (zero-egress env), this planted-label
    bound is the accuracy-parity regression guard. Calibrated measured
    values with these exact seeds/config: val 0.6825 / test 0.675 after
    5 epochs — the bound leaves margin for cross-version numeric drift
    but fails on any real training regression (chance = 0.143)."""
    cfg = _cfg(small_graph.num_classes)
    cfg = Config(dataset=cfg.dataset, sampler=cfg.sampler, model=cfg.model,
                 train=TrainConfig(learning_rate=0.01, epochs=5, seed=0))
    tr = Trainer(cfg, small_graph)
    for e in range(5):
        tr.train_one_epoch(e)
    val, test = tr.evaluate("valid"), tr.evaluate("test")
    assert val >= 0.55, f"val acc regression: {val} < 0.55 (was 0.6825)"
    assert test >= 0.55, f"test acc regression: {test} < 0.55 (was 0.675)"


def test_lp_eval_is_pair_weighted():
    """Eval aggregates LP loss as (pair-loss sum / pair count) across
    batches (r5 review finding): averaging per-batch MEANS over the step
    count weights a 1-pair final batch like a full one — and an empty
    batch (0 pairs, loss 0) would drag the reported loss toward 0."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from legion.train.loop import lp_logsigmoid_loss, lp_logsigmoid_sum

    rng = np.random.default_rng(0)
    emb_full = jnp.asarray(rng.normal(size=(12, 8)).astype(np.float32))
    emb_part = jnp.asarray(rng.normal(size=(12, 8)).astype(np.float32))
    m_full = jnp.ones((12,), bool)
    m_part = jnp.asarray([True] + [False] * 3 + [True] + [False] * 3
                         + [True] + [False] * 3)          # 1 valid pair

    s1, c1 = lp_logsigmoid_sum(emb_full, m_full)
    s2, c2 = lp_logsigmoid_sum(emb_part, m_part)
    assert int(c1) == 4 and int(c2) == 1
    # mean = sum / pairs (the train objective stays per-pair mean)
    np.testing.assert_allclose(float(lp_logsigmoid_loss(emb_full, m_full)),
                               float(s1) / 4, rtol=1e-6)
    agg = (float(s1) + float(s2)) / (int(c1) + int(c2))
    per_step = (float(s1) / 4 + float(s2) / 1) / 2
    # the two summaries genuinely differ on uneven batches; eval reports
    # the pair-weighted one
    assert not np.isclose(agg, per_step)
    # an empty batch contributes (0, 0) — a no-op in the aggregate
    s0, c0 = lp_logsigmoid_sum(emb_full, jnp.zeros((12,), bool))
    assert float(s0) == 0.0 and int(c0) == 0
