"""Scatter-dedup sampler (dense position map) tests.

The scatter variant appends new nodes in edge order (the sort variant
uses sorted-id order), so beyond hop 1 the RNG draw positions — and
therefore the sampled multisets — legitimately diverge from the sort
variant. Hop 1 must match draw-for-draw; afterwards we verify the
structural invariants + that stamps survive across batches without
clearing."""

import jax
import jax.numpy as jnp
import numpy as np

from legion.sampling.block import frontier_caps
from legion.sampling.sampler import (
    DeviceGraph, sample_batch, sample_batch_scatter)


def _check_invariants(batch, small_graph, num_valid_seeds):
    indptr = np.asarray(small_graph.indptr)
    indices = np.asarray(small_graph.indices)
    frontier = np.asarray(batch.frontier)
    nf = int(batch.num_frontier)
    # dense prefix of unique valid ids
    assert (frontier[:nf] >= 0).all() and (frontier[nf:] == -1).all()
    assert len(set(frontier[:nf].tolist())) == nf
    prev = num_valid_seeds
    for blk in batch.blocks:
        assert int(blk.num_dst) == prev
        ns = int(blk.num_src)
        pos = np.asarray(blk.nbr_pos)
        mask = np.asarray(blk.nbr_mask)
        assert (pos[mask] < ns).all() and (pos[mask] >= 0).all()
        # every valid edge is a true graph edge
        for d in range(pos.shape[0]):
            dst_gid = frontier[d]
            for f in range(pos.shape[1]):
                if mask[d, f]:
                    src_gid = frontier[pos[d, f]]
                    nbrs = indices[indptr[dst_gid]:indptr[dst_gid + 1]]
                    assert src_gid in nbrs
        prev = ns
    assert prev == nf


def test_scatter_dedup_invariants_and_hop1_parity(small_graph):
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    b, fanouts = 48, (5, 4)
    caps = frontier_caps(b, fanouts)
    seeds_np = np.unique(np.asarray(small_graph.train_ids)[:b]).astype(np.int32)
    seeds = np.full((b,), -1, np.int32)
    seeds[:len(seeds_np)] = seeds_np
    nb = jnp.full((), len(seeds_np), jnp.int32)
    labels = jnp.zeros((b,), jnp.int32)
    key = jax.random.PRNGKey(7)

    ref = sample_batch(key, g, jnp.asarray(seeds), nb, labels, fanouts, caps)
    n = small_graph.num_nodes
    got, pos_map, stamp = sample_batch_scatter(
        key, g, jnp.asarray(seeds), nb, labels, fanouts, caps,
        jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.int32),
        jnp.int32(1))

    # hop 1 uses identical draws => identical frontier SET after hop 1
    assert int(ref.blocks[0].num_src) == int(got.blocks[0].num_src)
    _check_invariants(got, small_graph, len(seeds_np))
    # seeds prefix preserved in order
    assert np.asarray(got.frontier)[:len(seeds_np)].tolist() == \
        seeds_np.tolist()


def test_scatter_stamp_survives_batches(small_graph):
    """Back-to-back batches reuse pos_map/stamp without clearing: each
    batch's frontier must still be duplicate-free and structurally
    valid (a stale stamp would leak prior batches' nodes)."""
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    b, fanouts = 32, (4, 3)
    caps = frontier_caps(b, fanouts)
    ids = np.asarray(small_graph.train_ids)
    n = small_graph.num_nodes
    pos_map = jnp.zeros((n,), jnp.int32)
    stamp = jnp.zeros((n,), jnp.int32)

    f = jax.jit(sample_batch_scatter, static_argnums=(5, 6),
                donate_argnums=(7, 8))
    for step in range(3):
        seeds = ids[step * b:(step + 1) * b].astype(np.int32)
        got, pos_map, stamp = f(jax.random.PRNGKey(step), g,
                                jnp.asarray(seeds),
                                jnp.full((), b, jnp.int32),
                                jnp.zeros((b,), jnp.int32), fanouts, caps,
                                pos_map, stamp, jnp.int32(step + 1))
        _check_invariants(jax.device_get(got), small_graph, b)
