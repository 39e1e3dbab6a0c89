"""Mesh trainer: the full training lifecycle (epochs, per-epoch
validation, final test, checkpoint/resume) on a multi-chip mesh with
HBM-resident features — replicated per chip or row-striped over the
``cache`` axis with collective row exchange.

This is the multi-chip twin of train.loop.Trainer and the SPMD rendering
of the reference's steady-state server: N free-running per-GPU runner
loops (``src/Server.cu:116-133``) + DDP training clients with the
train->valid-per-epoch->test mode schedule
(``src/CUDA_IPC_Service.cu:246-259``, ``legion_graphsage.py:149-181``).
Each epoch is ONE shard_mapped XLA program (a lax.scan over steps), so
there is no per-step dispatch at all. Host-resident features take the
striped-hot-cache path instead (train.striped_driver).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from legion.config import Config
from legion.data.format import GraphData, pad_feature_dim
from legion.models import build_model
from legion.parallel.dp import (MESH_AXES, make_dp_epoch_fns,
                                put_striped_features)
from legion.parallel.mesh import make_mesh
from legion.train.loop import sum_edge_counts
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph, gather_features, sample_batch
from legion.sampling.seeds import (
    interleave_shards,
    epoch_eval_seeds, epoch_train_seeds, make_seed_plan, shard_node_set)
from legion.train.train_state import (
    create_train_state, restore_checkpoint, save_checkpoint)




class MeshTrainer:
    """Data-parallel trainer over a (data x cache) mesh.

    Per-chip batch = cfg.sampler.batch_size (the reference's
    per-partition batch rule); global batch = n_chips x that.
    feature_placement "hbm" replicates the table per chip;
    "hbm_sharded" stripes rows over the ``cache`` axis and fetches via
    collectives (viable when the table fits aggregate but not per-chip
    HBM — the full-table degenerate of the hot-cache striping).
    """

    def __init__(self, cfg: Config, data: GraphData, mesh=None):
        self.cfg = cfg
        self.data = data
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.parallel.num_devices, cache_group_size=cfg.cache.group_size)
        n = self.n_shards = self.mesh.devices.size
        self._rep = NamedSharding(self.mesh, P())
        self._row = NamedSharding(self.mesh, P(MESH_AXES))
        self._mat = NamedSharding(self.mesh, P(None, MESH_AXES))

        self.graph = jax.device_put(
            DeviceGraph.from_host(data.indptr, data.indices), self._rep)
        feats_host = pad_feature_dim(np.asarray(data.features, np.float32),
                                     cfg.dataset.feature_pad_align or 1)
        self.sharded_features = (
            cfg.dataset.feature_placement == "hbm_sharded")
        if self.sharded_features:
            self.features = put_striped_features(feats_host, self.mesh)
        else:
            self.features = jax.device_put(jnp.asarray(feats_host),
                                           self._rep)

        self.shards_train = shard_node_set(data.train_ids, n)
        self.shards_valid = shard_node_set(data.valid_ids, n)
        self.shards_test = shard_node_set(data.test_ids, n)
        self.plan = make_seed_plan(
            [len(s) for s in self.shards_train],
            [max(len(s), 1) for s in self.shards_valid],
            [max(len(s), 1) for s in self.shards_test],
            cfg.sampler.batch_size, cfg.sampler.eval_batch_size)

        self.caps = frontier_caps(cfg.sampler.batch_size,
                                  cfg.sampler.fanouts)
        self.eval_caps = frontier_caps(cfg.sampler.eval_batch_size,
                                       cfg.sampler.fanouts)

        num_classes = cfg.dataset.num_classes or data.num_classes
        self.model = build_model(cfg.model.arch, cfg.model.hidden_dim,
                                 num_classes, cfg.model.num_layers,
                                 cfg.model.dropout, dtype=cfg.model.dtype)
        self.state = jax.device_put(self._init_state(feats_host), self._rep)
        if cfg.train.checkpoint_dir:
            restored = restore_checkpoint(cfg.train.checkpoint_dir,
                                          self.state)
            if restored is not None:
                self.state = jax.device_put(restored, self._rep)

        self.jit_epoch, _ = make_dp_epoch_fns(
            cfg, self.model, self.caps, self.mesh, self.sharded_features)
        _, self.jit_eval_scan = make_dp_epoch_fns(
            cfg, self.model, self.eval_caps, self.mesh,
            self.sharded_features)
        self.history: list[Dict] = []

    def _init_state(self, feats_host):
        cfg = self.cfg
        key = jax.random.PRNGKey(cfg.train.seed)
        b = cfg.sampler.batch_size
        seeds = jnp.arange(b, dtype=jnp.int32) % self.data.num_nodes
        batch = jax.jit(sample_batch, static_argnums=(5, 6))(
            key, self.graph, seeds, jnp.full((), b, jnp.int32),
            jnp.zeros((b,), jnp.int32), tuple(cfg.sampler.fanouts),
            self.caps)
        x = jnp.zeros((self.caps[-1], feats_host.shape[1]), jnp.float32)
        params = self.model.init(key, tuple(reversed(batch.blocks)), x,
                                 deterministic=True)["params"]
        return create_train_state(params, cfg.train.learning_rate,
                                  cfg.train.seed)

    # -- epochs ---------------------------------------------------------

    def train_one_epoch(self, epoch: int) -> Dict:
        rng = np.random.default_rng(self.cfg.train.seed * 100003 + epoch)
        seeds, _ = epoch_train_seeds(rng, self.shards_train, self.plan)
        labels = np.asarray(self.data.labels)[seeds].astype(np.int32)
        t0 = time.perf_counter()
        self.state, losses, (edges, overflow) = self.jit_epoch(
            self.state, self.graph, self.features,
            jax.device_put(interleave_shards(seeds), self._mat),
            jax.device_put(interleave_shards(labels), self._mat))
        losses = jax.device_get(losses)
        dt = time.perf_counter() - t0
        overflow = int(jax.device_get(overflow))
        if overflow > 0:
            from legion.utils.logging import log_metrics
            log_metrics({"event": "cap_overflow", "epoch": epoch,
                         "dropped_frontier_ids": overflow,
                         "hint": "raise sampler.observed_cap_slack"})
        rec = {"epoch": epoch, "first_loss": float(losses[0]),
               "loss": float(losses[-1]),
               "mean_loss": float(losses.mean()),
               "steps": int(losses.shape[0]), "cap_overflow": overflow,
               "epoch_s": dt, "edges_per_s": sum_edge_counts(edges) / dt}
        self.history.append(rec)
        return rec

    def evaluate(self, which: str = "valid") -> float:
        shards = self.shards_valid if which == "valid" else self.shards_test
        steps = (self.plan.valid_steps if which == "valid"
                 else self.plan.test_steps)
        per = (self.plan.valid_batch if which == "valid"
               else self.plan.test_batch)
        cap = self.cfg.sampler.eval_batch_size
        seeds, counts = epoch_eval_seeds(shards, steps, per, cap)
        labels_all = np.asarray(self.data.labels)
        lab = np.where(seeds >= 0, labels_all[np.clip(seeds, 0, None)],
                       -1).astype(np.int32)
        c, nmask = self.jit_eval_scan(
            self.state.params, self.graph, self.features,
            jax.device_put(interleave_shards(seeds), self._mat),
            jax.device_put(np.ascontiguousarray(counts.swapaxes(0, 1)),
                           self._mat),
            jax.device_put(interleave_shards(lab), self._mat),
            jax.device_put(jax.random.PRNGKey(12345), self._rep))
        return float(jax.device_get(c)) / max(float(jax.device_get(nmask)),
                                              1.0)

    def fit(self, epochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> Dict:
        epochs = epochs or self.cfg.train.epochs
        start = int(jax.device_get(self.state.epoch))
        if start > 0:
            log(f"resumed from checkpoint at epoch {start}")
        from legion.utils.logging import eval_labels
        vlab, tlab = eval_labels(self.cfg)
        for epoch in range(start, epochs):
            rec = self.train_one_epoch(epoch)
            acc = self.evaluate("valid")
            self.state = self.state.replace(
                epoch=jnp.full((), epoch + 1, jnp.int32))
            log(f"Epoch:{epoch}, Cost:{rec['epoch_s']:.3f} s, "
                f"Loss:{rec['loss']:.4f}, {vlab}: {acc:.4f}, "
                f"edges/s: {rec['edges_per_s']:.3e} "
                f"[mesh {dict(self.mesh.shape)}]")
            rec["valid"] = acc
            if self.cfg.train.checkpoint_dir:
                save_checkpoint(self.cfg.train.checkpoint_dir, self.state)
        test_acc = self.evaluate("test")
        log(f"{tlab}: {test_acc:.4f}")
        return {"test_acc": test_acc, "history": self.history,
                "mesh": dict(self.mesh.shape)}
