"""Kill-and-resume coverage for the scale drivers: the
cached driver checkpoints at epoch end (and optionally mid-epoch) and a
fresh process picks up exactly where the dead one stopped. The reference
has no checkpointing at all — a crash loses the run (SURVEY.md §5)."""

import os

import numpy as np

from legion.config import (CacheConfig, Config, DatasetConfig,
                           ModelConfig, SamplerConfig, TrainConfig)
from legion.train.cached_driver import run_cached_training
from legion.train.train_state import latest_checkpoint


def _cfg(small_graph, epochs, ck, every=0):
    return Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes,
                              feature_placement="host"),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32,
                              probe_caps=False),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0, epochs=epochs,
                          checkpoint_dir=ck,
                          checkpoint_every_steps=every),
        cache=CacheConfig(enabled=True, budget_bytes=64 << 10,
                          presample_steps=2),
    )


def test_cached_driver_kill_and_resume(small_graph, tmp_path):
    ck = str(tmp_path / "ck")
    logs1 = []
    out1 = run_cached_training(_cfg(small_graph, 1, ck, every=2),
                               small_graph, log=logs1.append)
    assert latest_checkpoint(ck) is not None
    # mid-epoch saves happened too (checkpoint_every_steps=2): more than
    # one step_* directory exists after a multi-step epoch
    steps = [d for d in os.listdir(ck) if d.startswith("step_")]
    assert len(steps) >= 2, steps

    # "crash" after epoch 0; a fresh driver resumes into epoch 1 only
    logs2 = []
    out2 = run_cached_training(_cfg(small_graph, 2, ck), small_graph,
                               log=logs2.append)
    assert any("resumed from checkpoint" in l for l in logs2)
    epochs_run = [r["epoch"] for r in out2["history"]]
    assert epochs_run == [1]
    assert np.isfinite(out2["history"][0]["loss"])
