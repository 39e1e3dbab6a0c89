"""LP-SAGE through EVERY trainer: each mesh /
cached / hybrid driver carries ``is_lp`` branches that previously only
the single-chip Trainer exercised. One lifecycle test per driver runs
``arch="lp_sage"`` end to end and checks (a) the LP loss is finite and
decreasing, (b) eval goes through the LP leg (mean -logsigmoid loss —
LOWER is better), (c) the epoch line is labeled "Val LP-loss", not
"Val Acc" (the figure is a loss; reference ``lp_sage.py:86-97``)."""

import numpy as np
import pytest

from legion.config import (CacheConfig, Config, DatasetConfig,
                           ModelConfig, ParallelConfig, SamplerConfig,
                           TrainConfig)

# batch 48: divisible by 3 (anchor/pos/neg thirds) and by the 2/4-way
# data axes used below
_SAMPLER = SamplerConfig(fanouts=(5, 4), batch_size=48, eval_batch_size=48)
_MODEL = ModelConfig(arch="lp_sage", hidden_dim=16, num_layers=2,
                     dropout=0.0)
_TRAIN = TrainConfig(learning_rate=0.01, epochs=2, seed=0)


def _base(small_graph, **ds):
    return DatasetConfig(num_classes=int(small_graph.num_classes), **ds)


def _check(history, logs, *, loss_key="loss", valid=None):
    assert np.isfinite(history[-1][loss_key])
    assert history[-1][loss_key] < history[0][loss_key] * 1.2
    # eval figure is a finite per-step mean LP loss COMPARABLE in scale
    # to the train loss (the eval denominator bug this guards against
    # reported ~loss/batch_size instead)
    valid = history[-1]["valid"] if valid is None else valid
    assert np.isfinite(valid)
    assert 0.0 <= valid, valid
    assert valid > history[-1][loss_key] * 0.2, (
        f"LP eval {valid} is an order of magnitude below the train loss "
        f"{history[-1][loss_key]} — wrong eval denominator?")
    assert any("Val LP-loss" in l for l in logs), logs[-3:]
    assert not any("Val Acc" in l for l in logs)


def test_lp_single_trainer(small_graph):
    from legion.train.loop import Trainer
    cfg = Config(dataset=_base(small_graph), sampler=_SAMPLER,
                 model=_MODEL, train=_TRAIN)
    logs = []
    tr = Trainer(cfg, small_graph)
    out = tr.fit(log=logs.append)
    _check(out["history"], logs, valid=tr.evaluate("valid"))
    assert any("LP-loss on test data" in l for l in logs)


def test_lp_mesh_trainer(small_graph):
    from legion.parallel.trainer import MeshTrainer
    cfg = Config(dataset=_base(small_graph), sampler=_SAMPLER,
                 model=_MODEL, train=_TRAIN,
                 parallel=ParallelConfig(num_devices=4))
    logs = []
    out = MeshTrainer(cfg, small_graph).fit(log=logs.append)
    _check(out["history"], logs)


def test_lp_cached_driver(small_graph):
    from legion.train.cached_driver import run_cached_training
    cfg = Config(
        dataset=_base(small_graph, feature_placement="host"),
        sampler=_SAMPLER, model=_MODEL, train=_TRAIN,
        cache=CacheConfig(enabled=True, budget_bytes=64 << 10,
                          presample_steps=2))
    logs = []
    out = run_cached_training(cfg, small_graph, log=logs.append)
    _check(out["history"], logs)


def test_lp_striped_driver(small_graph):
    from legion.train.striped_driver import run_striped_training
    cfg = Config(
        dataset=_base(small_graph, feature_placement="host"),
        sampler=_SAMPLER, model=_MODEL, train=_TRAIN,
        cache=CacheConfig(enabled=True, budget_bytes=64 << 10,
                          presample_steps=2, group_size=2),
        parallel=ParallelConfig(num_devices=4))
    logs = []
    out = run_striped_training(cfg, small_graph, log=logs.append)
    _check(out["history"], logs)


def test_lp_hybrid_driver(small_graph):
    from legion.train.hybrid_driver import run_hybrid_training
    cfg = Config(
        dataset=_base(small_graph, feature_placement="host",
                      topology_placement="host"),
        sampler=_SAMPLER, model=_MODEL, train=_TRAIN,
        cache=CacheConfig(enabled=True, budget_bytes=1 << 20,
                          presample_steps=2))
    logs = []
    out = run_hybrid_training(cfg, small_graph, log=logs.append)
    _check(out["history"], logs)


def test_lp_striped_hybrid_driver(small_graph):
    from legion.train.striped_hybrid_driver import (
        run_striped_hybrid_training)
    cfg = Config(
        dataset=_base(small_graph, feature_placement="host",
                      topology_placement="host"),
        sampler=_SAMPLER, model=_MODEL, train=_TRAIN,
        cache=CacheConfig(enabled=True, budget_bytes=1 << 20,
                          presample_steps=2, group_size=2),
        parallel=ParallelConfig(num_devices=2))
    logs = []
    out = run_striped_hybrid_training(cfg, small_graph, log=logs.append)
    _check(out["history"], logs)


def test_lp_partitioned_driver(small_graph):
    from legion.train.partitioned_driver import run_partitioned_training
    cfg = Config(dataset=_base(small_graph), sampler=_SAMPLER,
                 model=_MODEL, train=_TRAIN,
                 parallel=ParallelConfig(num_devices=4))
    logs = []
    out = run_partitioned_training(cfg, small_graph, log=logs.append)
    _check(out["history"], logs)
