"""MeshTrainer: the multi-chip HBM lifecycle (epochs + valid/test +
checkpoint/resume) on the virtual mesh, plus the train.py CLI path."""

import os
import subprocess
import sys

import jax
import numpy as np

from legion.config import (CacheConfig, Config, DatasetConfig,
                           ModelConfig, ParallelConfig, SamplerConfig,
                           TrainConfig)
from legion.parallel.trainer import MeshTrainer


def _cfg(small_graph, placement="hbm", epochs=2, ckpt=None, group=1):
    return Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes,
                              feature_placement=placement,
                              feature_pad_align=0),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32,
                              eval_batch_size=64, probe_caps=False),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0, epochs=epochs,
                          checkpoint_dir=ckpt),
        cache=CacheConfig(group_size=group),
        parallel=ParallelConfig(num_devices=4),
    )


def test_mesh_trainer_learns(small_graph):
    tr = MeshTrainer(_cfg(small_graph), small_graph)
    assert dict(tr.mesh.shape) == {"data": 4, "cache": 1}
    logs = []
    out = tr.fit(log=logs.append)
    assert len(out["history"]) == 2
    assert out["history"][1]["loss"] < out["history"][0]["loss"]
    chance = 1.0 / small_graph.num_classes
    assert out["history"][-1]["valid"] > 1.5 * chance
    assert out["test_acc"] > 1.5 * chance
    assert any("Val Acc" in l for l in logs)


def test_mesh_trainer_sharded_features(small_graph):
    """Row-striped feature table over the cache axis: same lifecycle,
    collective row fetch inside the step."""
    tr = MeshTrainer(_cfg(small_graph, placement="hbm_sharded", group=2,
                          epochs=1), small_graph)
    assert dict(tr.mesh.shape) == {"data": 2, "cache": 2}
    out = tr.fit(log=lambda s: None)
    assert np.isfinite(out["history"][0]["loss"])
    assert out["test_acc"] > 1.0 / small_graph.num_classes


def test_mesh_trainer_resume(small_graph, tmp_path):
    ck = str(tmp_path / "ck")
    tr = MeshTrainer(_cfg(small_graph, epochs=2, ckpt=ck), small_graph)
    out = tr.fit(log=lambda s: None)
    state_after = tr.state

    tr2 = MeshTrainer(_cfg(small_graph, epochs=3, ckpt=ck), small_graph)
    assert int(jax.device_get(tr2.state.epoch)) == 2
    logs = []
    out2 = tr2.fit(log=logs.append)
    assert any("resumed" in l for l in logs)
    assert len(out2["history"]) == 1   # only epoch 2 ran
    # resumed params match the saved ones before epoch 2 trained on them
    assert int(jax.device_get(tr2.state.step)) > int(
        jax.device_get(state_after.step)) - 1


def test_cli_multichip(tmp_path):
    """One command trains multi-epoch on the virtual mesh and prints
    Val/Test accuracy."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, LEGION_FORCE_CPU_DEVICES="8")
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "train.py"),
         "--synthetic", "1500", "--devices", "4", "--cache-group", "2",
         "--batch-size", "32", "--fanouts", "4,3", "--hidden-dim", "16",
         "--epochs", "2", "--features", "hbm"],
        capture_output=True, text=True, timeout=900, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Val Acc" in r.stdout
    assert "Accuracy on test data" in r.stdout
