"""Checkpoint format (.npz of raw leaf bytes + a treedef/shape/dtype
record) and the main path's independence from flax and orbax."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legion.train.train_state import (create_train_state, latest_checkpoint,
                                      restore_checkpoint, save_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(dtype, seed):
    rng = np.random.default_rng(seed)
    params = {"layer_0": {"kernel": jnp.asarray(
                  rng.standard_normal((5, 3)), dtype),
                          "bias": jnp.asarray(rng.standard_normal(3),
                                              jnp.float32)}}
    return create_train_state(params, 0.01, seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_checkpoint_roundtrip_bit_exact(tmp_path, dtype):
    state = _state(dtype, 3)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.37), state.params)
    state = state.apply_gradients(grads).apply_gradients(grads)
    state = state.replace(epoch=jnp.full((), 4, jnp.int32),
                          rng=jax.random.split(state.rng)[1])
    save_checkpoint(str(tmp_path), state)
    assert latest_checkpoint(str(tmp_path)).endswith("step_2.npz")
    restored = restore_checkpoint(str(tmp_path), _state(dtype, 9))
    got, want = jax.tree.leaves(restored), jax.tree.leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_checkpoint_rejects_another_model(tmp_path):
    save_checkpoint(str(tmp_path), _state("float32", 0))
    other = create_train_state({"layer_0": {"kernel": jnp.zeros((5, 4))}},
                               0.01, 0)
    with pytest.raises(ValueError, match="does not match"):
        restore_checkpoint(str(tmp_path), other)
    assert restore_checkpoint(str(tmp_path / "none"), other) is None


_NO_FLAX = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
import jax, jax.numpy as jnp, numpy as np
import train, bench, chip_smoke  # noqa: F401  (entry points import cleanly)
from legion.config import (Config, DatasetConfig, ModelConfig,
                           SamplerConfig, TrainConfig)
from legion.data.synthetic import random_power_law_graph
from legion.train.loop import Trainer
from legion.train.train_state import restore_checkpoint
g = random_power_law_graph(num_nodes=600, avg_degree=6, feature_dim=8,
                           num_classes=4, seed=0)
ck = sys.argv[1]
cfg = Config(dataset=DatasetConfig(num_classes=4),
             sampler=SamplerConfig(fanouts=(3, 2), batch_size=32),
             model=ModelConfig(hidden_dim=8, dropout=0.0),
             train=TrainConfig(epochs=1, checkpoint_dir=ck))
tr = Trainer(cfg, g)
tr.fit()
back = restore_checkpoint(ck, tr.state)
assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
           zip(jax.tree.leaves(back), jax.tree.leaves(tr.state)))
bad = [m for m in sys.modules if m.split(".")[0] in ("flax", "orbax")]
assert not bad, bad
print("NO_FLAX_OK", int(tr.state.step))
"""


def test_main_path_runs_without_flax_or_orbax(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _NO_FLAX, str(tmp_path)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_FLAX_OK" in r.stdout
    assert int(r.stdout.split("NO_FLAX_OK")[1].split()[0]) > 0
