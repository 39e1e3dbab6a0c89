"""End-to-end training driver.

Replaces three reference layers at once (SURVEY.md §1):

* the sampling server runtime (``src/Server.cu`` GPUServer/GPURunner):
  sampling + gather + training fuse into ONE jitted step (or a
  ``lax.scan`` over a whole epoch) — the 2-deep semaphore pipeline
  (``PIPELINE_DEPTH 2``) becomes XLA async dispatch, and the op-DAG over
  two CUDA streams becomes compiler-scheduled fusion;
* the CUDA-IPC boundary (``src/CUDA_IPC_Service.cu``): gone — one process;
* the client train loop (``pytorch_extension/legion_graphsage.py:119-184``):
  the epoch/valid/test schedule, loss and Adam step live here.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legion.config import Config
from legion.data.format import GraphData
from legion.models import build_model
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph, gather_features, sample_batch
from legion.sampling.seeds import (
    SeedPlan, epoch_eval_seeds, epoch_train_seeds, make_seed_plan, shard_node_set)
from legion.train.train_state import (
    TrainState, create_train_state, restore_checkpoint, save_checkpoint)


def sum_edge_counts(per_step) -> int:
    """Exact epoch edge total from per-step int32 counts: the device
    program keeps counts per step (each < 2^31) and the host reduces in
    int64 — the uk2014/clueweb-envelope rule for metering accumulators
    (tests/test_bigcsr.py::test_edge_total_accumulator_past_2_31)."""
    return int(np.asarray(jax.device_get(per_step), np.int64).sum())


class StepFns(NamedTuple):
    """Pure step functions built by make_step_fns. Callers destructure
    (train_step, eval_step, epoch_scan, eval_scan) or access by name."""
    train_step: Callable
    eval_step: Callable
    epoch_scan: Callable
    eval_scan: Callable


# ---------------------------------------------------------------------------
# Losses (reference: CrossEntropyLoss at legion_graphsage.py:142; LP loss at
# lp_sage.py:86-91).
# ---------------------------------------------------------------------------

def masked_softmax_ce(logits: jnp.ndarray, labels: jnp.ndarray,
                      mask: jnp.ndarray) -> jnp.ndarray:
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    safe = jnp.clip(labels, 0, logits.shape[-1] - 1)
    nll = -jnp.take_along_axis(logp, safe[:, None], axis=1)[:, 0]
    m = mask.astype(jnp.float32)
    return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)


def lp_logsigmoid_sum(emb: jnp.ndarray, mask: jnp.ndarray):
    """Link-prediction loss SUM and valid-pair count: batch thirds are
    (anchor, pos, neg); per pair -logsigmoid(a.p) - logsigmoid(-(a.n))
    (lp_sage.py:86-91). The (sum, pairs) form is what eval accumulates
    — summing per-batch MEANS and dividing by the step count weights a
    partial final batch (or an exhausted shard contributing 0 pairs)
    the same as a full one, biasing the reported LP loss toward 0."""
    emb = emb.astype(jnp.float32)   # reduce in f32 even for bf16 models
    third = emb.shape[0] // 3
    a, p, n = emb[:third], emb[third:2 * third], emb[2 * third:3 * third]
    m = (mask[:third] & mask[third:2 * third] & mask[2 * third:3 * third]
         ).astype(jnp.float32)
    pos = jax.nn.log_sigmoid(jnp.sum(a * p, -1))
    neg = jax.nn.log_sigmoid(-jnp.sum(a * n, -1))
    return (-(jnp.sum(pos * m) + jnp.sum(neg * m)),
            jnp.sum(m).astype(jnp.int32))


def lp_logsigmoid_loss(emb: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Mean-per-pair LP loss (the train objective, lp_sage.py:86-91)."""
    s, pairs = lp_logsigmoid_sum(emb, mask)
    return s / jnp.maximum(pairs.astype(jnp.float32), 1.0)


# ---------------------------------------------------------------------------
# Pure step functions
# ---------------------------------------------------------------------------

def make_step_fns(cfg: Config, model, caps,
                  feature_fetch: Optional[Callable] = None,
                  shard_axes: Tuple[str, ...] = ()):
    """Build (train_step, eval_step, epoch_scan) pure functions.

    feature_fetch(features_pytree, frontier) -> (frontier_cap, F) rows;
    defaults to the plain HBM gather. The cache subsystem supplies an
    alternative closure (see legion.cache).

    shard_axes: mesh axis names this step is shard_map'ped over. When
    set, each shard samples an independent batch (per-shard PRNG fold)
    and gradients/metrics are psum-averaged across the axes — the DDP
    all-reduce analog (reference ``legion_graphsage.py:140-141``).
    """
    fanouts = tuple(cfg.sampler.fanouts)
    dedup_last = cfg.sampler.dedup_last
    # mask_invalid=False: every consumer of the gathered rows masks
    # (aggregators by nbr_mask, loss/metrics by the seed mask), so the
    # zeroing pass over the largest array in the step is pure waste.
    fetch = feature_fetch or (lambda feats, frontier: gather_features(
        feats, frontier, mask_invalid=False))
    is_lp = cfg.model.arch == "lp_sage"

    def shard_key(key):
        if shard_axes:
            key = jax.random.fold_in(key, jax.lax.axis_index(shard_axes))
        return key

    def forward(params, batch, feats, dropout_rng, deterministic):
        x = fetch(feats, batch.frontier)
        # a feature_fetch may return (rows, overflow): requests the
        # striped-exchange fetch had to cap (zero rows — silently wrong
        # features unless surfaced; folded into cap_overflow below)
        fov = jnp.zeros((), jnp.int32)
        if isinstance(x, tuple):
            x, fov = x
        blocks = tuple(reversed(batch.blocks))
        rngs = {} if deterministic else {"dropout": dropout_rng}
        return model.apply({"params": params}, blocks, x,
                           deterministic=deterministic, rngs=rngs), fov

    def loss_fn(params, batch, feats, dropout_rng):
        out, fov = forward(params, batch, feats, dropout_rng,
                           deterministic=False)
        out = out[: batch.seed_cap]
        mask = batch.seed_mask()
        if is_lp:
            loss = lp_logsigmoid_loss(out, mask)
        else:
            loss = masked_softmax_ce(out, batch.labels, mask)
        return loss, fov

    def train_step(state: TrainState, graph: DeviceGraph, feats,
                   seeds, num_seeds, labels):
        key = shard_key(jax.random.fold_in(state.rng, state.step))
        skey, dkey = jax.random.split(key)
        batch = sample_batch(skey, graph, seeds, num_seeds, labels,
                             fanouts, caps, dedup_last=dedup_last)
        (loss, fetch_overflow), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, batch, feats, dkey)
        if shard_axes:
            # jax-0.9 shard_map (vma): the transpose of the implicit
            # pvary on the replicated params ALREADY all-reduce-sums
            # grads across shards inside value_and_grad. A pmean here
            # would (a) burn a second param-sized all-reduce and
            # (b) return the SUM anyway (pmean of identical sums),
            # silently scaling the effective lr by the shard count.
            # Divide by the shard count to get the DDP mean. Semantics
            # pinned by tests/test_comm_accounting.py (grads == the
            # single-chip grads of the same batches; exactly ONE
            # param-sized all-reduce in the compiled step).
            n_sh = 1
            for a in shard_axes:
                n_sh *= jax.lax.axis_size(a)
            grads = jax.tree.map(lambda g: g / n_sh, grads)
            loss = jax.lax.pmean(loss, shard_axes)
        state = state.apply_gradients(grads)
        edges = sum(b.num_edges() for b in batch.blocks)
        frontier = batch.num_frontier
        # overflow > 0 on any step means the caps must be loosened (the
        # reference has the same exposure with its 1.2x MaxIdNum buffers
        # and no check).
        overflow = batch.cap_overflow() + fetch_overflow
        if shard_axes:
            edges = jax.lax.psum(edges, shard_axes)
            frontier = jax.lax.psum(frontier, shard_axes)
            overflow = jax.lax.psum(overflow, shard_axes)
        metrics = {"loss": loss, "edges": edges, "frontier": frontier,
                   "cap_overflow": overflow}
        return state, metrics

    def eval_step(params, graph: DeviceGraph, feats, seeds, num_seeds,
                  labels, key):
        batch = sample_batch(shard_key(key), graph, seeds, num_seeds,
                             labels, fanouts, caps, dedup_last=dedup_last)
        out, _ = forward(params, batch, feats, None, deterministic=True)
        out = out[: batch.seed_cap]
        mask = batch.seed_mask()
        if is_lp:
            # (LP loss SUM, valid-pair count): eval_scan's a/b is then
            # the pair-weighted mean — partial final batches and
            # exhausted shards weigh by their real pair counts. (The
            # accuracy path's sum(mask) denominator — seeds, not pairs
            # — would report ~loss/batch_size; caught by
            # tests/test_lp_trainers.py.)
            a, b = lp_logsigmoid_sum(out, mask)
        else:
            pred = jnp.argmax(out, axis=-1)
            a, b = jnp.sum((pred == batch.labels) & mask), jnp.sum(mask)
        if shard_axes:
            a = jax.lax.psum(a, shard_axes)
            b = jax.lax.psum(b, shard_axes)
        return a, b

    def eval_scan(params, graph: DeviceGraph, feats, seeds_epoch,
                  counts, labels_epoch, key):
        """All eval steps in one scan (the reference's valid/test loops,
        legion_graphsage.py:159-181, without per-step dispatch)."""
        def body(carry, xs):
            a_sum, b_sum = carry
            seeds, nb, labels, k = xs
            a, b = eval_step(params, graph, feats, seeds, nb, labels, k)
            return (a_sum + a.astype(jnp.float32),
                    b_sum + b.astype(jnp.float32)), None

        steps = seeds_epoch.shape[0]
        keys = jax.random.split(key, steps)
        (a, b), _ = jax.lax.scan(
            body, (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)),
            (seeds_epoch, counts,
             labels_epoch, keys))
        return a, b

    def epoch_scan(state: TrainState, graph: DeviceGraph, feats,
                   seeds_epoch, labels_epoch):
        """Whole training epoch as one lax.scan — zero dispatch overhead,
        the single-program equivalent of the reference's free-running
        RunnerLoop (src/Server.cu:36-41)."""
        nb = jnp.full((), seeds_epoch.shape[1], jnp.int32)

        def body(st, xs):
            seeds, labels = xs
            st, m = train_step(st, graph, feats, seeds, nb, labels)
            return st, (m["loss"], m["edges"], m["cap_overflow"])

        # unroll: see TrainConfig.scan_unroll (the config is the source
        # of truth; the env var is an A/B override only).
        import os
        unroll = int(os.environ.get("LEGION_SCAN_UNROLL",
                                    cfg.train.scan_unroll))
        state, (losses, edges, overflow) = jax.lax.scan(
            body, state, (seeds_epoch, labels_epoch),
            unroll=min(unroll, seeds_epoch.shape[0]))
        # edges stays PER-STEP (steps,) int32: a device-side int32 sum
        # wraps past 2^31 — reachable at reference scales (8-chip DP at
        # batch 8000 x fanout [25,10] psums ~17M edges/step; a full
        # uk-class epoch crosses 2^31). Callers sum on host in int64
        # (sum_edge_counts); per-step counts are always < 2^31.
        return state, losses, (edges, jnp.sum(overflow))

    return StepFns(train_step=train_step, eval_step=eval_step,
                   epoch_scan=epoch_scan, eval_scan=eval_scan)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Single-host trainer (HBM-resident features path).

    The cached / multi-chip variants are built from the same pure step
    functions — see legion.cache.pipeline and legion.parallel.
    """

    def __init__(self, cfg: Config, data: GraphData, num_shards: int = 1):
        self.cfg = cfg
        self.data = data
        self.num_shards = num_shards

        self.graph = DeviceGraph.from_host(data.indptr, data.indices)
        from legion.data.format import pad_feature_dim
        self.features = jnp.asarray(
            pad_feature_dim(np.asarray(data.features, np.float32),
                            cfg.dataset.feature_pad_align or 1))

        self.shards_train = shard_node_set(data.train_ids, num_shards)
        self.shards_valid = shard_node_set(data.valid_ids, num_shards)
        self.shards_test = shard_node_set(data.test_ids, num_shards)
        self.plan = make_seed_plan(
            [len(s) for s in self.shards_train],
            [max(len(s), 1) for s in self.shards_valid],
            [max(len(s), 1) for s in self.shards_test],
            cfg.sampler.batch_size, cfg.sampler.eval_batch_size)

        self.caps = frontier_caps(cfg.sampler.batch_size, cfg.sampler.fanouts)
        self.eval_caps = frontier_caps(cfg.sampler.eval_batch_size,
                                       cfg.sampler.fanouts)
        if (cfg.sampler.probe_caps
                and self.caps[-1] >= cfg.sampler.probe_caps_min_cap):
            self.caps = self._probe_caps()

        num_classes = cfg.dataset.num_classes or data.num_classes
        self.model = build_model(cfg.model.arch, cfg.model.hidden_dim,
                                 num_classes, cfg.model.num_layers,
                                 cfg.model.dropout, dtype=cfg.model.dtype)
        self.state = self._init_state()
        if cfg.train.checkpoint_dir:
            restored = restore_checkpoint(cfg.train.checkpoint_dir, self.state)
            if restored is not None:
                self.state = restored

        fns = make_step_fns(cfg, self.model, self.caps)
        fns_eval = make_step_fns(cfg, self.model, self.eval_caps)
        self.jit_epoch = jax.jit(fns.epoch_scan, donate_argnums=(0,))
        self.jit_train_step = jax.jit(fns.train_step, donate_argnums=(0,))
        self.jit_eval_step = jax.jit(fns_eval.eval_step)
        self.jit_eval_scan = jax.jit(fns_eval.eval_scan)
        self.history: list[Dict] = []

    def _probe_caps(self):
        """Tighten static frontier caps to slack x the maxima realized on
        a few probe batches (the reference's 1.2 x observed MaxIdNum
        buffer sizing, ``src/Server.cu:273-282``) — worth one throwaway
        compile at loose caps: tightening alone cut step time ~2x at
        batch 8000. The last cap is exact when the final hop is
        identity-appended."""
        from legion.cache.hotness import observed_caps
        cfg = self.cfg
        b = cfg.sampler.batch_size
        fanouts = tuple(cfg.sampler.fanouts)
        loose = frontier_caps(b, fanouts)
        sb = jax.jit(sample_batch, static_argnums=(5, 6))
        rng = np.random.default_rng(cfg.train.seed * 7919 + 1)
        ids = np.asarray(self.shards_train[0])
        mx = np.zeros(len(fanouts) + 1, np.int64)
        for i in range(cfg.sampler.probe_caps_batches):
            seeds = rng.permutation(ids)[:b].astype(np.int32)
            if len(seeds) < b:
                seeds = np.pad(seeds, (0, b - len(seeds)),
                               constant_values=-1)
            batch = sb(jax.random.PRNGKey(1000 + i), self.graph,
                       jnp.asarray(seeds),
                       jnp.full((), (np.asarray(seeds) >= 0).sum(),
                                jnp.int32),
                       jnp.zeros((b,), jnp.int32), fanouts, loose)
            counts = [int(batch.num_seeds)] + [int(blk.num_src)
                                               for blk in batch.blocks]
            mx = np.maximum(mx, counts)
        caps = list(observed_caps(mx, cfg.sampler.observed_cap_slack,
                                  align=128))
        caps = [min(c, l) for c, l in zip(caps, loose)]
        if not cfg.sampler.dedup_last:   # identity append: exact extent
            caps[-1] = caps[-2] * (1 + fanouts[-1])
        caps = tuple(caps)
        from legion.utils.logging import log_metrics
        log_metrics({"event": "cap_probe", "observed": mx.tolist(),
                     "caps": list(caps), "loose": list(loose)})
        return caps

    def _init_state(self) -> TrainState:
        cfg = self.cfg
        key = jax.random.PRNGKey(cfg.train.seed)
        b = cfg.sampler.batch_size
        seeds = jnp.arange(b, dtype=jnp.int32) % self.data.num_nodes
        labels = jnp.zeros((b,), jnp.int32)
        batch = jax.jit(sample_batch, static_argnums=(5, 6))(
            key, self.graph, seeds, jnp.full((), b, jnp.int32), labels,
            tuple(cfg.sampler.fanouts),
            frontier_caps(b, cfg.sampler.fanouts))
        x = jax.jit(gather_features)(self.features, batch.frontier)
        params = self.model.init(key, tuple(reversed(batch.blocks)), x,
                                 deterministic=True)["params"]
        return create_train_state(params, cfg.train.learning_rate,
                                  cfg.train.seed)

    # -- epoch loops --------------------------------------------------------

    def train_one_epoch(self, epoch: int, shard: int = 0) -> Dict:
        rng = np.random.default_rng(self.cfg.train.seed * 100003 + epoch)
        seeds, _ = epoch_train_seeds(rng, [self.shards_train[shard]], self.plan)
        labels = np.asarray(self.data.labels)[seeds[0]]
        import contextlib
        prof = (jax.profiler.trace(self.cfg.train.profile_dir)
                if self.cfg.train.profile_dir and epoch == 0
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with prof:
            self.state, losses, (edges, overflow) = self.jit_epoch(
                self.state, self.graph, self.features,
                jnp.asarray(seeds[0]), jnp.asarray(labels))
            losses = jax.device_get(losses)
        dt = time.perf_counter() - t0
        overflow = int(jax.device_get(overflow))
        if overflow > 0:
            from legion.utils.logging import log_metrics
            log_metrics({"event": "cap_overflow", "epoch": epoch,
                         "dropped_frontier_ids": overflow,
                         "hint": "raise sampler.observed_cap_slack"})
        # exact byte accounting (PCM-counter replacement, SURVEY.md §5):
        # every step gathers frontier_cap feature rows from HBM
        feat_bytes = (self.plan.train_steps * self.caps[-1]
                      * self.features.shape[1] * 4)
        rec = {"epoch": epoch, "first_loss": float(losses[0]),
               "loss": float(losses[-1]),
               "mean_loss": float(losses.mean()),
               "steps": int(losses.shape[0]), "cap_overflow": overflow,
               "epoch_s": dt, "edges_per_s": sum_edge_counts(edges) / dt,
               "feature_gb": feat_bytes / 2 ** 30}
        self.history.append(rec)
        from legion.utils.logging import log_metrics
        log_metrics({"event": "train_epoch", **rec})
        return rec

    def evaluate(self, which: str = "valid", shard: int = 0) -> float:
        shards = self.shards_valid if which == "valid" else self.shards_test
        steps = (self.plan.valid_steps if which == "valid"
                 else self.plan.test_steps)
        per = (self.plan.valid_batch if which == "valid"
               else self.plan.test_batch)
        cap = self.cfg.sampler.eval_batch_size
        seeds, counts = epoch_eval_seeds([shards[shard]], steps, (per[shard],), cap)
        labels_all = np.asarray(self.data.labels)
        lab = np.where(seeds[0] >= 0, labels_all[np.clip(seeds[0], 0, None)],
                       -1).astype(np.int32)
        c, n = self.jit_eval_scan(
            self.state.params, self.graph, self.features,
            jnp.asarray(seeds[0]), jnp.asarray(counts[0]),
            jnp.asarray(lab), jax.random.PRNGKey(12345))
        return float(jax.device_get(c)) / max(float(jax.device_get(n)), 1.0)

    def fit(self, epochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> Dict:
        epochs = epochs or self.cfg.train.epochs
        start = int(jax.device_get(self.state.epoch))
        from legion.utils.logging import eval_labels
        vlab, tlab = eval_labels(self.cfg)
        for epoch in range(start, epochs):
            rec = self.train_one_epoch(epoch)
            acc = self.evaluate("valid")
            self.state = self.state.replace(
                epoch=jnp.full((), epoch + 1, jnp.int32))
            log(f"Epoch:{epoch}, Cost:{rec['epoch_s']:.3f} s, "
                f"Loss:{rec['loss']:.4f}, {vlab}: {acc:.4f}, "
                f"edges/s: {rec['edges_per_s']:.3e}")
            if self.cfg.train.checkpoint_dir:
                save_checkpoint(self.cfg.train.checkpoint_dir, self.state)
        test_acc = self.evaluate("test")
        log(f"{tlab}: {test_acc:.4f}")
        return {"test_acc": test_acc, "history": self.history}
