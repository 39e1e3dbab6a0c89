"""Training state + checkpoint/resume.

The reference has no checkpointing at all (SURVEY.md §5) — a crash loses
the run. Here the full state (params, Adam state, step/epoch counters and
the sampler PRNG key) round-trips bit-exactly through one ``.npz`` file
per checkpoint, so training is resumable and elastic.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray          # () int32 global step
    epoch: jnp.ndarray         # () int32
    rng: jax.Array             # sampler+dropout PRNG key (split per step)

    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True))

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads) -> "TrainState":
        updates, new_opt = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            params=optax.apply_updates(self.params, updates),
            opt_state=new_opt, step=self.step + 1)


def create_train_state(params, learning_rate: float, seed: int) -> TrainState:
    """Adam, matching the reference optimizer/config
    (``legion_graphsage.py:144``, lr 0.003 default)."""
    tx = optax.adam(learning_rate)
    return TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(seed), tx=tx)


# -- checkpointing ---------------------------------------------------------
#
# One file per checkpoint, ``<dir>/step_<N>.npz``: every leaf of the
# (params, opt_state, step, epoch, rng) tree stored as raw bytes, plus a
# JSON record of the treedef, shapes and dtypes. Restoring checks that
# record against the template state, so a checkpoint from another model
# shape fails loudly instead of loading into the wrong slots; the bytes
# make the round trip exact for every dtype (bf16 and the raw uint32
# PRNG key included).


def _payload(state: TrainState):
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step, "epoch": state.epoch, "rng": state.rng}


def _leaf_record(leaves, treedef) -> str:
    return json.dumps({
        "treedef": str(treedef),
        "shapes": [list(np.shape(x)) for x in leaves],
        "dtypes": [str(x.dtype) for x in leaves]})


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    leaves, treedef = jax.tree.flatten(jax.device_get(_payload(state)))
    leaves = [np.asarray(x) for x in leaves]
    arrays = {f"leaf_{i}": np.ascontiguousarray(x).reshape(-1).view(np.uint8)
              for i, x in enumerate(leaves)}
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{int(state.step)}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, record=np.asarray(_leaf_record(leaves, treedef)), **arrays)
    os.replace(tmp, path)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", d)
        if m:
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}.npz")


def restore_checkpoint(ckpt_dir: str, state: TrainState) -> Optional[TrainState]:
    """Restore the latest checkpoint into the given (template) state;
    returns None when no checkpoint exists. Each leaf is placed with the
    template leaf's sharding."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None
    tmpl, treedef = jax.tree.flatten(_payload(state))
    with np.load(path) as f:
        got = f["record"].item()
        want = _leaf_record(tmpl, treedef)
        if got != want:
            raise ValueError(f"checkpoint {path} does not match the "
                             f"model/optimizer state: {got} != {want}")
        leaves = []
        for i, t in enumerate(tmpl):
            a = f[f"leaf_{i}"].view(t.dtype).reshape(np.shape(t))
            leaves.append(jax.device_put(a, t.sharding)
                          if isinstance(t, jax.Array) else a)
    return state.replace(**jax.tree.unflatten(treedef, leaves))


def maybe_checkpoint_step(train_cfg, state: TrainState, step_index: int
                          ) -> None:
    """Mid-epoch checkpoint cadence (TrainConfig.checkpoint_every_steps),
    shared by the pipelined trainers so the cadence can't drift between
    drivers."""
    if (train_cfg.checkpoint_dir and train_cfg.checkpoint_every_steps
            and (step_index + 1) % train_cfg.checkpoint_every_steps == 0):
        save_checkpoint(train_cfg.checkpoint_dir, state)
