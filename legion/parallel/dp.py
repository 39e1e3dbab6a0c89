"""Multi-chip training step: DP over the full mesh, features optionally
striped over the ``cache`` axis.

Maps the reference's runtime parallelism (SURVEY.md §2 checklist) onto a
mesh: every chip is an independent sampler+trainer (the per-GPU
GPURunner, ``src/Server.cu:167-368``), gradients are pmean'd across the
whole mesh (DDP/NCCL, ``legion_graphsage.py:140-141``), and feature rows
can be striped across the ``cache`` axis with collective row exchange
(the NVLink Kg clique, ``src/GPUCache.cu:103-108`` — see
feature_exchange).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legion.config import Config
from legion.parallel.feature_exchange import (
    shard_rows, sharded_row_fetch_stats)
from legion.train.loop import make_step_fns

MESH_AXES = ("data", "cache")


def put_striped_features(features: np.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Round-robin-stripe the feature table over the cache axis and place
    it: returns a (K*cap, D) global array sharded P('cache') whose local
    shard on chip j is stripe j (rows with id % K == j)."""
    k = mesh.shape["cache"]
    striped = shard_rows(np.asarray(features), k)         # (K, cap, D)
    flat = striped.reshape(k * striped.shape[1], striped.shape[2])
    sharding = NamedSharding(mesh, P("cache"))
    return jax.device_put(flat, sharding)


def make_dp_train_step(cfg: Config, model, caps, mesh: Mesh,
                       sharded_features: bool = False):
    """Returns (jitted_step, shardings) where jitted_step(state, graph,
    feats, seeds, num_seeds, labels) -> (state, metrics).

    seeds/labels: (total_batch,) sharded over (data, cache) — every chip
    trains on its own slice; num_seeds: per-shard valid count
    (replicated scalar).
    """
    fetch = None
    if sharded_features:
        # stats variant: capped requests (zero rows) are counted and
        # folded into the step's cap_overflow metric by make_step_fns
        fetch = lambda feats, frontier: sharded_row_fetch_stats(  # noqa: E731
            feats, frontier, "cache")
    train_step, eval_step, *_ = make_step_fns(
        cfg, model, caps, feature_fetch=fetch, shard_axes=MESH_AXES)

    feats_spec = P("cache") if sharded_features else P()
    in_specs = (P(), P(), feats_spec, P(MESH_AXES), P(), P(MESH_AXES))
    step = jax.jit(
        jax.shard_map(train_step, mesh=mesh, in_specs=in_specs,
                      out_specs=(P(), P())),
        donate_argnums=(0,))

    eval_specs = (P(), P(), feats_spec, P(MESH_AXES), P(), P(MESH_AXES), P())
    ev = jax.jit(
        jax.shard_map(eval_step, mesh=mesh, in_specs=eval_specs,
                      out_specs=(P(), P())))
    return step, ev


def make_dp_epoch_fns(cfg: Config, model, caps, mesh: Mesh,
                      sharded_features: bool = False):
    """Whole-epoch mesh programs: (jit_epoch, jit_eval_scan).

    jit_epoch(state, graph, feats, seeds_epoch, labels_epoch)
        -> (state, losses, (edges, overflow))
      seeds/labels: (steps, n_shards*batch) sharded over the mesh on the
      batch dim — each chip scans its own per-step sub-batch, gradients
      pmean across the mesh every step (the reference's free-running
      RunnerLoop + DDP, ``src/Server.cu:36-41``,
      ``legion_graphsage.py:140-141``, as ONE XLA program per epoch).

    jit_eval_scan(params, graph, feats, seeds, counts, labels, key)
        -> (correct, total) psum'd across the mesh.
      counts: (steps, n_shards) per-chip valid counts (short eval shards
      pad with -1, the Coordinate lockstep rule).
    """
    fetch = None
    if sharded_features:
        fetch = lambda feats, frontier: sharded_row_fetch_stats(  # noqa: E731
            feats, frontier, "cache")
    fns = make_step_fns(cfg, model, caps, feature_fetch=fetch,
                        shard_axes=MESH_AXES)

    def eval_scan_wrap(params, graph, feats, seeds, counts, labels, key):
        return fns.eval_scan(params, graph, feats, seeds, counts[:, 0],
                             labels, key)

    feats_spec = P("cache") if sharded_features else P()
    ep_specs = (P(), P(), feats_spec, P(None, MESH_AXES), P(None, MESH_AXES))
    jit_epoch = jax.jit(
        jax.shard_map(fns.epoch_scan, mesh=mesh, in_specs=ep_specs,
                      out_specs=(P(), P(), (P(), P()))),
        donate_argnums=(0,))
    ev_specs = (P(), P(), feats_spec, P(None, MESH_AXES),
                P(None, MESH_AXES), P(None, MESH_AXES), P())
    jit_eval = jax.jit(
        jax.shard_map(eval_scan_wrap, mesh=mesh, in_specs=ev_specs,
                      out_specs=(P(), P())))
    return jit_epoch, jit_eval
