"""Cached training pipeline: device sampling + HBM hot-row cache + host
miss staging, double-buffered.

This replaces the reference's decoupled
sampling-server / training-client architecture (SURVEY.md pillar 3).
There, a C++ server samples and gathers into per-(device, pipe-slot)
buffers guarded by POSIX semaphores while the torch client trains on the
other slot (``src/CUDA_IPC_Service.cu:34-37,140-201``, PIPELINE_DEPTH 2).
Here both halves live in one process and the pipeline is expressed with
JAX async dispatch:

  step i:   [device] sample+plan  ->  [host] stage misses  ->  [device] train
  step i+1:          sample+plan overlaps train(i)  (dispatched first)

Only the small miss-id array crosses device->host per step; miss rows
cross host->device. Both are exactly metered (metrics.host_bytes).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.feature_cache import FeatureCache
from legion.config import Config
from legion.sampling.sampler import DeviceGraph, sample_batch
from legion.train.loop import (lp_logsigmoid_loss, lp_logsigmoid_sum,
                               masked_softmax_ce)
from legion.train.train_state import TrainState


def make_cache_step_fns(cfg: Config, model):
    """Pure (train_from, eval_from) over a pre-sampled batch + cache
    plan + staged miss rows. Shared by CachedTrainer (device sampling)
    and the hybrid driver (host+device sampling).

    Cache arrays are ARGUMENTS, not closures: closed-over device arrays
    become XLA program literals and a ~1GB cache overflows compile
    limits (see FeatureCache).
    """
    is_lp = cfg.model.arch == "lp_sage"

    def train_from(state: TrainState, rows, batch, plan, staged):
        def loss_fn(params, dkey):
            x = FeatureCache.combine_rows(rows, plan, staged,
                                          batch.frontier)
            blocks = tuple(reversed(batch.blocks))
            out = model.apply({"params": params}, blocks, x,
                              deterministic=False,
                              rngs={"dropout": dkey})
            out = out[: batch.seed_cap]
            mask = batch.seed_mask()
            if is_lp:
                return lp_logsigmoid_loss(out, mask)
            return masked_softmax_ce(out, batch.labels, mask)

        key = jax.random.fold_in(state.rng, state.step)
        _, dkey = jax.random.split(key)
        loss, grads = jax.value_and_grad(loss_fn)(state.params, dkey)
        state = state.apply_gradients(grads)
        return state, {"loss": loss, "cap_overflow": batch.cap_overflow()}

    def eval_from(params, rows, batch, plan, staged):
        x = FeatureCache.combine_rows(rows, plan, staged, batch.frontier)
        blocks = tuple(reversed(batch.blocks))
        out = model.apply({"params": params}, blocks, x,
                          deterministic=True)
        out = out[: batch.seed_cap]
        mask = batch.seed_mask()
        if is_lp:
            # (loss SUM, valid-pair count): the caller's a/b is the
            # pair-weighted mean — same aggregation as accuracy
            return lp_logsigmoid_sum(out, mask)
        pred = jnp.argmax(out, axis=-1)
        return jnp.sum((pred == batch.labels) & mask), jnp.sum(mask)

    return train_from, eval_from


class CachedTrainer:
    """Train with host-resident features behind a FeatureCache.

    Pass a host_stage callable to override the numpy miss gather (the
    C++ runtime's threaded gather, legion.runtime.gather_rows).
    """

    def __init__(self, cfg: Config, model, caps, graph: DeviceGraph,
                 cache: FeatureCache, host_stage=None):
        self.cfg = cfg
        self.model = model
        self.caps = tuple(caps)
        self.graph = graph
        self.cache = cache
        self.host_stage = host_stage or cache.stage
        self.is_lp = cfg.model.arch == "lp_sage"
        fanouts = tuple(cfg.sampler.fanouts)

        def sample_plan(key, graph, hot_ids, seeds, num_seeds, labels):
            # dedup_last=True always: with host-resident features every
            # duplicate frontier row costs host->device bytes, so dedup
            # pays here (the reference's PCIe-saving rationale) even
            # though the HBM path elides it.
            batch = sample_batch(key, graph, seeds, num_seeds, labels,
                                 fanouts, self.caps, dedup_last=True)
            plan = FeatureCache.plan_ids(hot_ids, batch.frontier,
                                         cache.miss_cap)
            # [hit, miss, valid, overflow | miss_ids]: ONE device->host
            # transfer per step carries everything the host loop needs
            # (each separate scalar fetch would be a round trip).
            packed = jnp.concatenate([
                jnp.stack([plan.num_hit, plan.num_miss, plan.num_valid,
                           plan.overflow()]),
                plan.miss_ids])
            return batch, plan, packed

        train_from, eval_from = make_cache_step_fns(cfg, model)
        self.jit_sample_plan = jax.jit(sample_plan)
        self.jit_train_from = jax.jit(train_from, donate_argnums=(0,))
        self.jit_eval_from = jax.jit(eval_from)

    def run_epoch(self, state: TrainState, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray,
                  depth: Optional[int] = None) -> Dict:
        """Python-orchestrated pipelined epoch.

        depth: prefetch depth (reference PIPELINE_DEPTH=2,
        src/Server.cu:15): sample+plan for up to `depth` future steps is
        dispatched before the current train step blocks on staging.
        """
        depth = depth or self.cfg.train.pipeline_depth
        steps = seeds_epoch.shape[0]
        b = seeds_epoch.shape[1]
        nb = jnp.full((), b, jnp.int32)
        key = jax.random.fold_in(state.rng, int(jax.device_get(state.epoch)))

        t0 = time.perf_counter()
        inflight = []  # (batch, plan) futures, dispatch order
        losses, cap_overflow = [], []
        hits = misses = valid = overflow = 0
        host_bytes = 0

        def dispatch(i):
            k = jax.random.fold_in(key, i)
            inflight.append(self.jit_sample_plan(
                k, self.graph, self.cache.hot_ids,
                jnp.asarray(seeds_epoch[i]), nb,
                jnp.asarray(labels_epoch[i])))

        for i in range(min(depth, steps)):
            dispatch(i)
        for i in range(steps):
            batch, plan, packed = inflight.pop(0)
            # host staging: ONE device->host transfer (stats + miss ids)
            packed = np.asarray(packed)
            n_hit, n_miss, n_valid, n_over = (int(x) for x in packed[:4])
            staged = self.host_stage(packed[4:])
            state, m = self.jit_train_from(state, self.cache.rows,
                                           batch, plan,
                                           jnp.asarray(staged))
            if i + depth < steps:
                dispatch(i + depth)
            losses.append(m["loss"])
            cap_overflow.append(m["cap_overflow"])
            hits += n_hit
            misses += n_miss
            valid += n_valid
            overflow += n_over
            host_bytes += (min(n_miss, staged.shape[0])
                           * staged.shape[1] * staged.dtype.itemsize)
            from legion.train.train_state import maybe_checkpoint_step
            maybe_checkpoint_step(self.cfg.train, state, i)

        losses, cap_overflow = jax.device_get((losses, cap_overflow))
        dt = time.perf_counter() - t0
        return {
            "state": state, "steps": steps, "seconds": dt,
            "first_loss": float(losses[0]) if losses else float("nan"),
            "loss": float(losses[-1]) if losses else float("nan"),
            "cap_overflow": int(sum(cap_overflow)),
            "cache_hit_rate": hits / max(valid, 1),
            "host_gb": host_bytes / 2 ** 30,
            "staging_overflow": overflow,
        }

    def eval_epoch(self, params, seeds: np.ndarray, counts: np.ndarray,
                   labels: np.ndarray, key=None,
                   depth: Optional[int] = None) -> float:
        """Deterministic eval through the cached feature path; returns
        accuracy (classification) or mean LP loss.

        Pipelined like run_epoch (sample+plan dispatched `depth` steps
        ahead so host staging overlaps device eval) and accumulated on
        device — ONE scalar fetch per epoch instead of two per step."""
        key = key if key is not None else jax.random.PRNGKey(4242)
        depth = depth or self.cfg.train.pipeline_depth
        steps = seeds.shape[0]
        inflight = []

        def dispatch(t):
            inflight.append(self.jit_sample_plan(
                jax.random.fold_in(key, t), self.graph,
                self.cache.hot_ids, jnp.asarray(seeds[t]),
                jnp.full((), int(counts[t]), jnp.int32),
                jnp.asarray(labels[t])))

        a_acc = b_acc = None
        for t in range(min(depth, steps)):
            dispatch(t)
        for t in range(steps):
            batch, plan, packed = inflight.pop(0)
            staged = self.host_stage(np.asarray(packed)[4:])
            a, b = self.jit_eval_from(params, self.cache.rows, batch, plan,
                                      jnp.asarray(staged))
            if t + depth < steps:
                dispatch(t + depth)
            a = a.astype(jnp.float32)
            b = b.astype(jnp.float32)
            a_acc = a if a_acc is None else a_acc + a
            b_acc = b if b_acc is None else b_acc + b
        # LP and accuracy aggregate identically: a = sum (pair losses /
        # correct predictions), b = count (pairs / masked seeds) — a/b
        # weights partial final batches by their real contents
        a_sum = float(jax.device_get(a_acc)) if steps else 0.0
        return a_sum / max(float(jax.device_get(b_acc)), 1.0) if steps \
            else float("nan")
