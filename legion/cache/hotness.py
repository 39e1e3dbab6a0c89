"""Presampling hotness measurement.

The reference dedicates a profiling epoch before training: sampling runs
without feature extraction while per-node access counters accumulate —
``kernel_pre_sampler_optimized`` bumps ``edge_access_time`` per CSR row
read (``src/Kernels.cu:525``) and ``HotnessMeasure`` counts sampled-node
occurrences (``src/GPUCache.cu:227-235``). It also observes the realized
maximum sampled-id count, later used to size feature buffers at 1.2x
(``src/Server.cu:273-282``).

Here the same presampling epoch is a ``lax.scan`` of the
jitted sampler; hotness histograms are scatter-adds into dense (N,)
count arrays, and the observed per-hop frontier/valid counts come back
as reduced scalars — no atomics, no hardware counters.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legion.sampling.sampler import DeviceGraph, sample_batch


class HotnessResult(NamedTuple):
    node_hot: jnp.ndarray      # (N,) int32: feature-access counts
    edge_hot: jnp.ndarray      # (N,) int32: adjacency-row read counts
    max_frontier: jnp.ndarray  # () int32: max unique nodes per batch
    max_per_hop: jnp.ndarray   # (hops+1,) int32: max valid count per level


def presample_hotness(key: jax.Array, graph: DeviceGraph,
                      seeds_epoch: jnp.ndarray, num_seeds: jnp.ndarray,
                      fanouts: Sequence[int], caps: Sequence[int],
                      num_nodes: int) -> HotnessResult:
    """Run a presampling epoch and return hotness histograms.

    seeds_epoch: (steps, seed_cap) int32; num_seeds: (steps,) int32.

    Feature hotness counts every unique frontier membership (those rows
    would be gathered); topology hotness counts every time a node's
    adjacency row is consumed by a sampler hop (all levels except the
    outermost, whose nodes are never expanded).
    """
    fanouts = tuple(fanouts)
    caps = tuple(caps)

    def body(carry, xs):
        node_hot, edge_hot, maxf, max_hop = carry
        seeds, nb, k = xs
        batch = sample_batch(k, graph, seeds, nb, jnp.zeros_like(seeds),
                             fanouts, caps)
        fvalid = batch.frontier >= 0
        fids = jnp.where(fvalid, batch.frontier, num_nodes)
        node_hot = node_hot.at[fids].add(fvalid.astype(jnp.int32),
                                         mode="drop")
        # rows read: every valid node of every level but the last; the
        # level-k node set is the first num_k entries of the frontier
        # (prefix invariant), so one masked add per level suffices.
        level_counts = [batch.num_seeds] + [b.num_src for b in batch.blocks]
        for lv in range(len(fanouts)):
            nvalid = level_counts[lv]
            m = (jnp.arange(caps[-1], dtype=jnp.int32) < nvalid) & fvalid
            edge_hot = edge_hot.at[fids].add(m.astype(jnp.int32), mode="drop")
        maxf = jnp.maximum(maxf, batch.num_frontier)
        max_hop = jnp.maximum(max_hop, jnp.stack(level_counts))
        return (node_hot, edge_hot, maxf, max_hop), None

    steps = seeds_epoch.shape[0]
    keys = jax.random.split(key, steps)
    init = (jnp.zeros((num_nodes,), jnp.int32),
            jnp.zeros((num_nodes,), jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((len(fanouts) + 1,), jnp.int32))
    (node_hot, edge_hot, maxf, max_hop), _ = jax.lax.scan(
        body, init, (seeds_epoch, num_seeds, keys))
    return HotnessResult(node_hot, edge_hot, maxf, max_hop)


def observed_caps(max_per_hop, slack: float = 1.2, align: int = 8,
                  last_exact_fanout: int | None = None) -> Tuple[int, ...]:
    """Tightened static frontier caps from presampling observation —
    the reference's 1.2 x MaxIdNum buffer sizing (src/Server.cu:275)
    turned into recompile-with-tighter-shapes.

    last_exact_fanout: set to fanouts[-1] when the consumer samples with
    dedup_last=False — the final cap is then the exact identity-append
    extent caps[-2]*(1+fanout), not an observed (deduped) count.
    """
    m = np.asarray(max_per_hop)
    caps = np.ceil(m * slack / align).astype(int) * align
    caps = np.maximum.accumulate(caps)
    if last_exact_fanout is not None:
        caps[-1] = caps[-2] * (1 + last_exact_fanout)
    return tuple(int(c) for c in caps)


def host_frontier_probe(indptr, indices, seed_batches, fanouts, caps,
                        visit, rng, seed_base: int = 0):
    """Re-grow multi-hop frontiers with the HOST sampler for probe
    statistics (numpy; no device programs). The shared engine behind
    every host-side cap probe (striped-hybrid owner caps, halo
    per-distance caps): engine choice cannot change frontier
    COMPOSITION statistics, so the threaded C++ sampler stands in for
    the mesh program; frontiers beyond a hop's cap are randomly
    subsampled (truncating the sorted unique() array would bias toward
    low ids).

    ``visit(hop, frontier)`` is called with the frontier a hop samples
    FROM for hop in [0, len(fanouts)), and once more with
    hop == len(fanouts) for the final (feature-fetch) frontier.
    """

    from legion import runtime
    indptr = np.ascontiguousarray(np.asarray(indptr), np.int64)
    indices = np.ascontiguousarray(np.asarray(indices), np.int32)
    for bi, seeds in enumerate(seed_batches):
        seeds = np.asarray(seeds)
        frontier = seeds[seeds >= 0].astype(np.int64)
        for hop, f in enumerate(fanouts):
            visit(hop, frontier)
            nbrs = runtime.sample_neighbors(
                indptr, indices, frontier.astype(np.int32), f,
                seed=seed_base + bi * 997 + hop)
            grown = np.unique(np.concatenate(
                [frontier, nbrs[nbrs >= 0].astype(np.int64)]))
            if len(grown) > caps[hop + 1]:
                grown = grown[rng.permutation(len(grown))
                              [: caps[hop + 1]]]
            frontier = grown
        visit(len(fanouts), frontier)


def staging_rows(node_hot, cached_ids, batches: int, frontier_cap: int,
                 floor: float = 0.0) -> int:
    """Per-batch host staging capacity for feature-cache misses: 1.5x
    the misses per batch the presampling histogram predicts for the
    cached set (or ``floor``, e.g. an unbiased probe's maximum, when
    larger), plus frontier_cap/16 + 1024 rows of headroom; a multiple of
    128, at most the frontier. Misses beyond it read as zeros and are
    reported as staging overflow."""
    hot = np.asarray(node_hot, np.int64)
    miss = (hot.sum() - hot[np.asarray(cached_ids)].sum()) / max(batches, 1)
    need = max(float(miss), float(floor)) * 1.5 + frontier_cap / 16 + 1024
    return int(min(frontier_cap, (int(need) + 127) // 128 * 128))
