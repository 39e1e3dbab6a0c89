"""Full multi-host training step over an edge-partitioned graph.

The flagship beyond-reference configuration (BASELINE.json config #5:
"GraphSAGE on ogbn-papers100M, edge-partitioned across N>=2 hosts with
halo exchange"): no host holds the whole graph or feature table; each
hop interleaves remote neighbor expansion (partitioned_sample_hop) with
local dedup/renumber, features arrive via halo exchange, and gradients
pmean across hosts. Across hosts the `data` axis spans processes
(collectives ride NVLink within a host, the network between hosts);
tests run the same
program on the virtual CPU mesh.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legion.config import Config
from legion.parallel.halo import (
    HostShard, partitioned_row_fetch, partitioned_row_fetch_exact,
    partitioned_sample_hop, partitioned_sample_hop_exact)
from legion.sampling.block import SampledBatch
from legion.sampling.sampler import grow_frontier
from legion.train.loop import (lp_logsigmoid_loss, lp_logsigmoid_sum,
                               masked_softmax_ce)
from legion.train.train_state import TrainState

AXIS = "data"


def sample_batch_partitioned(shard: HostShard, key: jax.Array,
                             seeds: jnp.ndarray, num_seeds: jnp.ndarray,
                             labels: jnp.ndarray, fanouts: Sequence[int],
                             caps: Sequence[int], owner_of=None,
                             dist_caps=None):
    """Multi-hop sampling where each hop's neighbor expansion is served
    by the partition owners (inside shard_map). Dedup/renumbering stays
    host-local — frontier numbering is per-host, exactly as each
    reference GPU runner numbers its own batch.

    dist_caps set => EXACT per-distance exchange (draws bit-identical to
    the psum path; over-cap requests return -1 and are counted). Returns
    (batch, overflow)."""
    caps = tuple(caps)
    frontier = jnp.full((caps[0],), -1, jnp.int32).at[: seeds.shape[0]].set(seeds)
    num = num_seeds.astype(jnp.int32)
    blocks = []
    overflow = jnp.zeros((), jnp.int32)
    for k, fanout in enumerate(fanouts):
        key, sub = jax.random.split(key)
        if dist_caps is not None:
            nbrs, ov = partitioned_sample_hop_exact(
                shard, owner_of, sub, frontier, fanout, AXIS, dist_caps)
            overflow = overflow + ov
        else:
            nbrs = partitioned_sample_hop(shard, sub, frontier, fanout,
                                          AXIS)
        frontier, num, blk = grow_frontier(frontier, num, nbrs, caps[k + 1])
        blocks.append(blk)
    return SampledBatch(seeds=seeds, labels=labels,
                        num_seeds=num_seeds.astype(jnp.int32),
                        frontier=frontier, num_frontier=num,
                        blocks=tuple(blocks)), overflow


def _partitioned_step_fns(cfg: Config, model, caps, dist_caps=None):
    """Pure per-shard step functions (inside shard_map over AXIS).

    dist_caps: static per-distance halo caps (len K-1) => the exact
    ppermute exchange serves both neighbor expansion and the feature
    fetch; None => the v1 psum exchange (cap-free oracle). The step
    signature is identical either way — ``owner`` (the replicated (N,)
    partition-id table) is simply unused by the psum path."""
    fanouts = tuple(cfg.sampler.fanouts)
    is_lp = cfg.model.arch == "lp_sage"

    def sample_and_fetch(shard, owner_t, key, seeds, ns, labels):
        batch, ov = sample_batch_partitioned(
            shard, key, seeds, ns, labels, fanouts, caps,
            owner_of=owner_t, dist_caps=dist_caps)
        if dist_caps is not None:
            x, fov = partitioned_row_fetch_exact(
                shard, owner_t, batch.frontier, AXIS, dist_caps)
            ov = ov + fov
        else:
            x = partitioned_row_fetch(shard, batch.frontier, AXIS)
        return batch, x, ov

    def step(state: TrainState, owned, sp, si, fr, owner_t, seeds,
             num_seeds, labels):
        shard = HostShard(owned_ids=owned[0], sub_indptr=sp[0],
                          sub_indices=si[0], feat_rows=fr[0])
        ns = num_seeds[0]  # (K,)-sharded: this host's valid seed count
        key = jax.random.fold_in(state.rng, state.step)
        key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
        skey, dkey = jax.random.split(key)
        batch, x, halo_ov = sample_and_fetch(shard, owner_t, skey, seeds,
                                             ns, labels)

        def loss_fn(params):
            blocks = tuple(reversed(batch.blocks))
            out = model.apply({"params": params}, blocks, x,
                              deterministic=False, rngs={"dropout": dkey})
            out = out[: batch.seed_cap]
            mask = batch.seed_mask()
            if is_lp:
                return lp_logsigmoid_loss(out, mask)
            return masked_softmax_ce(out, batch.labels, mask)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        # already psummed across hosts by the vma transpose (see
        # train.loop.train_step); divide for the DDP mean
        grads = jax.tree.map(lambda g: g / jax.lax.axis_size(AXIS), grads)
        loss = jax.lax.pmean(loss, AXIS)
        state = state.apply_gradients(grads)
        edges = jax.lax.psum(sum(b.num_edges() for b in batch.blocks), AXIS)
        # over-cap halo requests (zero rows / -1 draws) — the exact
        # exchange's loud-failure contract: persistent nonzero means
        # the probed dist_caps must be loosened
        halo_ov = jax.lax.psum(halo_ov, AXIS)
        return state, {"loss": loss, "edges": edges,
                       "halo_overflow": halo_ov}

    def eval_step(params, owned, sp, si, fr, owner_t, seeds, ns, labels,
                  key):
        # ns: () this host's valid seed count for the step
        shard = HostShard(owned_ids=owned[0], sub_indptr=sp[0],
                          sub_indices=si[0], feat_rows=fr[0])
        key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
        batch, x, halo_ov = sample_and_fetch(shard, owner_t, key, seeds,
                                             ns, labels)
        out = model.apply({"params": params},
                          tuple(reversed(batch.blocks)), x,
                          deterministic=True)
        out = out[: batch.seed_cap]
        mask = batch.seed_mask()
        if is_lp:
            # (LP loss SUM, valid-pair count): the driver's c/n is then
            # the pair-weighted mean over shards x steps (see
            # train.loop.eval_step — dividing by sum(mask), the seed
            # count, would report ~loss/batch).
            a, b = lp_logsigmoid_sum(out, mask)
        else:
            pred = jnp.argmax(out, axis=-1)
            a, b = jnp.sum((pred == batch.labels) & mask), jnp.sum(mask)
        # eval drops are as silent-accuracy-corrupting as train drops:
        # surface them (same loud contract)
        return (jax.lax.psum(a.astype(jnp.float32), AXIS),
                jax.lax.psum(b.astype(jnp.float32), AXIS),
                jax.lax.psum(halo_ov, AXIS))

    def epoch_scan(state, owned, sp, si, fr, owner_t, seeds_epoch,
                   num_seeds, labels_epoch):
        """Whole partitioned epoch as one program (steps on the leading
        axis of seeds/labels)."""
        def body(st, xs):
            seeds, labels = xs
            st, m = step(st, owned, sp, si, fr, owner_t, seeds,
                         num_seeds, labels)
            return st, (m["loss"], m["edges"], m["halo_overflow"])

        state, (losses, edges, ov) = jax.lax.scan(
            body, state, (seeds_epoch, labels_epoch))
        # per-step edges (int32 each): host sums in int64 — a device
        # int32 sum wraps past 2^31 at reference epoch scales (see
        # train.loop.sum_edge_counts)
        return state, losses, edges, jnp.sum(ov)

    def eval_scan(params, owned, sp, si, fr, owner_t, seeds_epoch,
                  counts, labels_epoch, key):
        def body(carry, xs):
            a_s, b_s, o_s = carry
            seeds, nb, labels, k = xs
            a, b, ov = eval_step(params, owned, sp, si, fr, owner_t,
                                 seeds, nb, labels, k)
            return (a_s + a, b_s + b, o_s + ov), None

        steps = seeds_epoch.shape[0]
        keys = jax.random.split(key, steps)
        (a, b, ov), _ = jax.lax.scan(
            body, (jnp.zeros((), jnp.float32),
                   jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32)),
            (seeds_epoch, counts[:, 0], labels_epoch, keys))
        return a, b, ov

    return step, eval_step, epoch_scan, eval_scan


def owner_table(partition: np.ndarray, mesh: Mesh,
                enabled: bool = True) -> jnp.ndarray:
    """Replicated (N,) int8 partition-id table — the requester-side
    owner lookup of the exact halo exchange (the reference keeps a dense
    (N,) position map per GPU for the same reason, src/Server.cu:222;
    int8 bounds it to N bytes per chip for K <= 127).

    enabled=False (the psum exchange, which needs no owner lookup)
    returns the 1-element replicated placeholder the step signature
    still expects — kept HERE so the dtype/sharding contract has one
    home (callers: make_partitioned_train_step.put_shards and the
    partitioned driver)."""
    if not enabled:
        return jax.device_put(jnp.zeros(1, jnp.int8),
                              NamedSharding(mesh, P()))
    assert int(partition.max(initial=0)) < 127
    return jax.device_put(jnp.asarray(partition.astype(np.int8)),
                          NamedSharding(mesh, P()))


def probe_dist_caps(indptr, indices, partition: np.ndarray, shards,
                    fanouts, caps, k: int, batch: int,
                    slack: float = 1.3, probes: int = 2,
                    seed: int = 0) -> Tuple[int, ...]:
    """Observed per-ring-distance request maxima for the exact halo
    exchange, probed host-side from the partition vector + a few
    re-grown frontiers (VERDICT r4 #2: per-owner bounds are a static
    function of the partition's boundary sets; realized per-batch counts
    concentrate well below them, so probing a few batches and capping at
    ``slack`` x the max is the frontier-cap discipline applied to the
    halo; frontier regrow via cache.hotness.host_frontier_probe, the
    shared probe engine).

    The caller must probe at the LARGEST batch the caps will serve
    (train AND eval — make_partitioned_epoch_fns shares one cap set).
    Returns len K-1 static caps (distance r bound at index r-1),
    8-aligned, clipped to the frontier cap."""
    rng = np.random.default_rng(seed * 7907 + 3)
    batches = [(i, rng.permutation(np.asarray(shards[i]))[:batch])
               for bi in range(probes) for i in range(k)
               if len(shards[i])]
    return probe_dist_caps_batches(indptr, indices, partition, batches,
                                   fanouts, caps, k, slack=slack,
                                   seed=seed)


def probe_dist_caps_batches(indptr, indices, partition: np.ndarray,
                            batches, fanouts, caps, k: int,
                            slack: float = 1.3,
                            seed: int = 0) -> Tuple[int, ...]:
    """probe_dist_caps over EXPLICIT (requester_host, seed_ids) batches
    — for seed compositions that are deterministic rather than sampled
    (the eval schedule's enumerated chunks, epoch_eval_seeds: probing
    the actual batches covers eval exactly, where a random subset of
    the shard can miss a boundary-clustered chunk)."""
    from legion.cache.hotness import host_frontier_probe
    from legion.parallel.feature_exchange import probed_cap
    rng = np.random.default_rng(seed * 7907 + 3)
    dmax = np.zeros(k, np.int64)

    for bi, (i, ids) in enumerate(batches):
        ids = np.asarray(ids)
        ids = ids[ids >= 0]
        if not len(ids):
            continue

        def visit(hop, frontier, i=i):
            dist = (partition[frontier] - i) % k
            np.maximum(dmax, np.bincount(dist, minlength=k),
                       out=dmax)

        host_frontier_probe(
            indptr, indices, [ids], fanouts, caps, visit,
            rng, seed_base=1300 + bi * 1009)
    return tuple(probed_cap(int(dmax[r]), caps[-1], slack)
                 for r in range(1, k))


def make_partitioned_train_step(cfg: Config, model, caps, mesh: Mesh,
                                dist_caps=None):
    """Returns (jitted_step, put_shards).

    jitted_step(state, owned, sub_indptr, sub_indices, feat_rows,
                owner, seeds, num_seeds, labels) -> (state, metrics)
    with the shard arrays stacked (K, ...) and sharded over `data` and
    ``owner`` the replicated (N,) partition table (owner_table; any
    1-element placeholder works for the psum path).

    dist_caps: per-distance halo caps (probe_dist_caps) => exact
    ppermute exchange; None => v1 psum exchange.
    """
    step, *_ = _partitioned_step_fns(cfg, model, caps,
                                     dist_caps=dist_caps)

    # num_seeds: (K,) int32, one valid-count per host (short shards pad
    # their seed batch with -1 — the Coordinate lockstep rule).
    specs = (P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(),
             P(AXIS), P(AXIS), P(AXIS))
    jitted = jax.jit(
        jax.shard_map(step, mesh=mesh, in_specs=specs,
                      out_specs=(P(), P())),
        donate_argnums=(0,))

    def put_shards(indptr, indices, features, partition: np.ndarray):
        k = mesh.shape[AXIS]
        parts = HostShard.build(indptr, indices, features, partition, k)
        stacked = [np.stack([p[i] for p in parts]) for i in range(4)]
        sh = NamedSharding(mesh, P(AXIS))
        # the psum path never reads the owner table — don't pin (N,)
        # bytes of HBM per chip for an ignored argument
        owner = owner_table(partition, mesh,
                            enabled=dist_caps is not None)
        return tuple(jax.device_put(jnp.asarray(a), sh)
                     for a in stacked) + (owner,)

    return jitted, put_shards


def make_partitioned_epoch_fns(cfg: Config, model, caps, mesh: Mesh,
                               eval_caps=None, dist_caps=None):
    """Whole-epoch partitioned programs: (jit_epoch, jit_eval_scan).

    jit_epoch(state, owned, sp, si, fr, owner, seeds_epoch, num_seeds,
              labels_epoch) -> (state, losses, edges, halo_overflow)
      seeds/labels: (steps, K*batch) sharded on the batch dim;
      num_seeds: (K,) per-host valid counts (full batches: drop-last).
    jit_eval_scan(params, ..., seeds, counts, labels, key) ->
      (correct, total); counts: (steps, K) per-host per-step counts.
    dist_caps: see make_partitioned_train_step.
    """
    _, _, epoch_scan, _ = _partitioned_step_fns(cfg, model, caps,
                                                dist_caps=dist_caps)
    _, _, _, eval_scan = _partitioned_step_fns(cfg, model,
                                               eval_caps or caps,
                                               dist_caps=dist_caps)
    ax = P(AXIS)
    ep_specs = (P(), ax, ax, ax, ax, P(), P(None, AXIS), ax,
                P(None, AXIS))
    jit_epoch = jax.jit(
        jax.shard_map(epoch_scan, mesh=mesh, in_specs=ep_specs,
                      out_specs=(P(), P(), P(), P())),
        donate_argnums=(0,))
    ev_specs = (P(), ax, ax, ax, ax, P(), P(None, AXIS), P(None, AXIS),
                P(None, AXIS), P())
    jit_eval = jax.jit(
        jax.shard_map(eval_scan, mesh=mesh, in_specs=ev_specs,
                      out_specs=(P(), P(), P())))
    return jit_epoch, jit_eval
