"""Device neighbor sampling: jitted, static shapes, no atomics.

Replaces the reference's CUDA sampling pipeline (``src/Kernels.cu``):

* ``kernel_random_sampler_2`` (``src/Kernels.cu:342-448``): per (seed,
  slot), uniform neighbor draw **with replacement**; slots beyond the
  node's degree yield ``-1``. Reproduced exactly (vectorized uniform draw
  scaled by degree), with JAX PRNG replacing ``thrust::minstd_rand``
  seeded by thread index.
* atomic-bitmap dedup + position map (``src/Kernels.cu:412-438``):
  replaced by a sort-based ``jnp.unique(..., size=cap)`` with
  first-occurrence bookkeeping that preserves the cumulative
  ``[seeds, hop1-new, hop2-new]`` numbering.
* ``construct_graph`` COO renumbering (``src/Kernels.cu:450-463``):
  subsumed — positions fall out of the unique's inverse permutation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import dataclasses

import jax
import jax.numpy as jnp

from legion.sampling.block import Block, SampledBatch, frontier_caps

# Padding sentinel that sorts AFTER every real node id, so unique() packs
# real ids into a dense prefix. Externally padding is -1 (the reference's
# sentinel, src/Kernels.cu:296); internally we flip to SENTINEL for sorts.
SENTINEL = jnp.iinfo(jnp.int32).max


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """CSR topology resident in device HBM.

    int32 indptr: device CSR addressing is 32-bit, which caps on-device
    topology at 2^31 edges — graphs beyond that use the host/topology-cache
    path (reference keeps the full CSR zero-copy in pinned host memory for
    the same reason, ``src/GPUGraphStore.cu:264-266``).

    ``indices`` is zero-padded to a 128-multiple so it can be viewed as
    (lines, 128) int32 = 512-byte HBM lines for windowed sampling;
    ``big_deg_count`` statically bounds how many nodes exceed the
    window (they take the per-edge tail path). 0 compiles the tail out.
    """

    indptr: jnp.ndarray    # (N+1,) int32
    indices: jnp.ndarray   # (E_pad,) int32, E_pad % 128 == 0
    big_deg_count: int = dataclasses.field(default=-1,
                                       metadata=dict(static=True))
    # Line-aligned layout only ("aligned"): per-node run starts into the
    # padded ``indices``. Runs are placed so a run of degree <= 128 never
    # straddles a 512B line: one descriptor fetches it and the lane
    # select examines 128 candidates instead of WINDOW_LINES*128.
    astart: jnp.ndarray | None = None   # (N,) int32 or None
    # (N, 2) int32 [run_start, degree]: per-node metadata packed so the
    # sampler issues ONE row gather per frontier node instead of three
    # scalar gathers (indptr[ids], indptr[ids+1], astart[ids]).
    meta: jnp.ndarray | None = None
    # Direct-addressed layout ("lined"): node i's adjacency lives in
    # 512B line i of ``indices`` viewed as (N, 128) — lanes 0..126 hold
    # (up to) the first 127 neighbors, lane 127 the full degree. The
    # line index IS the node id, so sampling a hop needs ONE descriptor
    # per node, full stop (the aligned layout needs two: the packed
    # meta row for (start, deg), then the line). Costs 512B/node of
    # topology HBM regardless of degree — from_host("auto") picks it
    # only under ``lined_max_bytes``. Nodes with degree > 127 take the
    # per-edge tail path reading the original CSR (``tail_indices``).
    lined: bool = dataclasses.field(default=False,
                                 metadata=dict(static=True))
    tail_indices: jnp.ndarray | None = None

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @classmethod
    def from_host(cls, indptr, indices, window_lines: int = 2,
                  layout: str = "auto",
                  aligned_max_expand: float = 2.0,
                  lined_max_bytes: int = 2 << 30,
                  lined_max_expand: float = 4.0) -> "DeviceGraph":
        """layout:
        * "auto" (default): "lined" when the graph is small enough
          (num_nodes * 512B <= lined_max_bytes) AND the flat 512B/node
          doesn't balloon sparse graphs (lined bytes <=
          ``lined_max_expand`` x edge bytes, with a 64 MiB floor so tiny
          graphs always qualify — without the relative guard a 4M-node /
          8M-edge graph would jump from ~32 MB windowed to 2 GiB of
          topology HBM); else "aligned".
        * "lined": direct-addressed — 512B line per node id, degree
          stored in-line (lane 127), so a sampled hop costs ONE
          descriptor per node (no meta-row gather). Topology HBM =
          num_nodes x 512B; nodes with
          degree > 127 fall to a per-edge tail over the original CSR.
        * "aligned": adjacency runs re-packed so every run of
          degree <= 64 starts at a 64-lane boundary and every larger run
          at a 128-lane (512B line) boundary — no run with deg <= 128
          straddles a line. Placement is two-region (all >64-degree runs
          first, then all 64-slot runs) so both alignment classes hold
          exactly (~1.3x topology HBM at products-scale degree ~50).
          Falls back to windowed when padding would exceed
          ``aligned_max_expand`` x the edge count (low-degree graphs pad
          up to 64x) or 2^31 lanes.
        * "windowed": indices kept verbatim (zero-padded to a 128
          multiple); runs may straddle, so sampling fetches
          ``window_lines`` lines per node.
        """
        import numpy as np
        assert int(indptr[-1]) < 2 ** 31, (
            "on-device CSR needs < 2^31 edges; use host topology placement")
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        e = int(indptr[-1])
        deg = np.diff(indptr).astype(np.int64)
        n = deg.shape[0]
        if layout == "auto":
            layout = ("lined" if n * 512 <= lined_max_bytes
                      and n * 512 <= lined_max_expand * max(e * 4, 64 << 20)
                      and n * 128 < 2 ** 31 else "aligned")
        if layout == "lined":
            assert n * 128 < 2 ** 31, "lined layout needs N*128 < 2^31"
            lcap = 127
            lines = np.zeros((n, 128), np.int32)
            inline = np.minimum(deg, lcap)
            dst = (np.arange(n, dtype=np.int64) * 128).repeat(inline) \
                + _concat_ranges(inline)
            src = indptr[:-1].repeat(inline) + _concat_ranges(inline)
            lines.reshape(-1)[dst] = indices[src]
            lines[:, 127] = np.minimum(deg, np.iinfo(np.int32).max)
            big = int((deg > lcap).sum())
            tail = None
            if big > 0:
                epad = (e + 127) // 128 * 128
                tail = np.zeros(epad, np.int32)
                tail[:e] = indices[:e]
            return cls(
                indptr=jnp.asarray(indptr, dtype=jnp.int32),
                indices=jnp.asarray(lines.reshape(-1)),
                big_deg_count=big,
                lined=True,
                tail_indices=None if tail is None else jnp.asarray(tail),
                meta=jnp.asarray(
                    np.stack([indptr[:-1], deg], axis=1).astype(np.int32)))
        if layout == "aligned":
            size = np.where(deg == 0, 0,
                            np.where(deg <= 64, 64,
                                     (deg + 127) // 128 * 128))
            epad = int(size.sum())
            if epad < 2 ** 31 and epad <= aligned_max_expand * max(e, 1):
                # two-region placement: big (>64) runs first — cumsum of
                # 128-multiples keeps every one 128-aligned — then the
                # 64-slot runs (64-aligned within a 128-aligned base; a
                # deg<=64 run at a 64 boundary never straddles a line).
                big = deg > 64
                astart = np.empty(deg.shape[0], np.int64)
                bsz = size[big]
                astart[big] = np.cumsum(bsz) - bsz
                base = int(bsz.sum())          # multiple of 128
                ssz = size[~big]
                astart[~big] = base + np.cumsum(ssz) - ssz
                packed = np.zeros(max(128, (epad + 127) // 128 * 128),
                                  np.int32)
                dst = np.repeat(astart - indptr[:-1], deg) + np.arange(
                    e, dtype=np.int64)
                packed[dst] = indices[:e]
                return cls(
                    indptr=jnp.asarray(indptr, dtype=jnp.int32),
                    indices=jnp.asarray(packed),
                    big_deg_count=int((deg > 128).sum()),
                    astart=jnp.asarray(astart, dtype=jnp.int32),
                    meta=jnp.asarray(
                        np.stack([astart, deg], axis=1).astype(np.int32)))
        e = indices.shape[0]
        epad = (e + 127) // 128 * 128
        if epad != e:
            indices = np.pad(indices, (0, epad - e))
        # worst case for a window: run starts at lane 127 of its first line
        big = int((deg > window_lines * 128 - 127).sum())
        return cls(indptr=jnp.asarray(indptr, dtype=jnp.int32),
                   indices=jnp.asarray(indices, dtype=jnp.int32),
                   big_deg_count=big,
                   meta=jnp.asarray(
                       np.stack([indptr[:-1], deg], axis=1).astype(np.int32)))

    def run_starts(self, ids: jnp.ndarray) -> jnp.ndarray:
        """Start offsets of the given nodes' adjacency runs in ``indices``
        (layout-aware)."""
        return (self.astart[ids] if self.astart is not None
                else self.indptr[ids])

    def node_meta(self, ids: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(run_start, degree) per node — one packed row gather when
        ``meta`` is present (graphs built before the field existed, e.g.
        restored from old pytrees, fall back to scalar lookups)."""
        if self.meta is not None:
            m = self.meta[ids]
            return m[:, 0], m[:, 1]
        return self.run_starts(ids), self.indptr[ids + 1] - self.indptr[ids]


# Adjacency window width for line-granular sampling, in 512B HBM lines
# (128 int32 lanes each). Nodes whose CSR run can straddle more than
# WINDOW_LINES lines take the compacted per-edge tail path.
WINDOW_LINES = 2


def _concat_ranges(counts):
    """[arange(c) for c in counts], concatenated (numpy, host-side)."""
    import numpy as np
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - starts.repeat(counts)


def _draws(key, deg, p, fanout):
    """Uniform-with-replacement draw offsets in [0, deg) per (node, slot);
    0 where deg == 0 (masked by the caller)."""
    u = jax.random.uniform(key, (p, fanout), dtype=jnp.float32)
    return jnp.minimum((u * deg[:, None].astype(jnp.float32)).astype(jnp.int32),
                       jnp.maximum(deg[:, None] - 1, 0))


def _select_lanes(win: jnp.ndarray, off: jnp.ndarray) -> jnp.ndarray:
    """out[p, f] = win[p, off[p, f]], exact for every id.

    An integer lane gather: no float round trip, so ids of any width
    survive (a one-hot float contraction is exact only below 2^24, and
    below 2^11 where an f32 dot may run in TF32)."""
    return jnp.take_along_axis(win, off, axis=1)


def sample_neighbors_per_edge(key: jax.Array, graph: DeviceGraph,
                              frontier: jnp.ndarray,
                              fanout: int) -> jnp.ndarray:
    """One 4-byte HBM gather per sampled edge — the direct analog of the
    reference's per-thread reads (``src/Kernels.cu:399-411``). Kept as
    the fallback for graphs built without window metadata and as the
    oracle for the windowed path (bit-identical draws)."""
    p = frontier.shape[0]
    valid = frontier >= 0
    ids = jnp.where(valid, frontier, 0)
    start, deg = graph.node_meta(ids)               # (P,), (P,)
    off = _draws(key, deg, p, fanout)
    if graph.lined:
        # lined layout: in-line adjacency for deg <= 127, original CSR
        # (tail_indices) otherwise; draws are identical either way.
        inline = ids[:, None] * 128 + jnp.minimum(off, 126)
        nbr = graph.indices[jnp.clip(inline, 0,
                                     graph.indices.shape[0] - 1)]
        if graph.tail_indices is not None:
            tl = start[:, None] + off
            nbr_tl = graph.tail_indices[jnp.clip(
                tl, 0, graph.tail_indices.shape[0] - 1)]
            nbr = jnp.where((deg <= 127)[:, None], nbr, nbr_tl)
    else:
        addr = start[:, None] + off
        nbr = graph.indices[jnp.clip(addr, 0, graph.indices.shape[0] - 1)]
    slot = jax.lax.broadcasted_iota(jnp.int32, (p, fanout), 1)
    ok = valid[:, None] & (slot < deg[:, None]) & (deg[:, None] > 0)
    return jnp.where(ok, nbr, -1)


def sample_neighbors(key: jax.Array, graph: DeviceGraph,
                     frontier: jnp.ndarray, fanout: int) -> jnp.ndarray:
    """Uniform-with-replacement fanout sampling of one hop.

    frontier: (P,) int32 global ids, -1 padding. Returns (P, fanout) int32
    neighbor ids with -1 where the slot is invalid (padded source, or slot
    index >= degree — reference semantics, src/Kernels.cu:399-400).

    Strategy: one 4-byte gather per edge uses a small part of each
    memory transaction, so each node's CSR run is fetched line-granular
    (one 512B line per NODE) and the sampled lanes are selected from the
    fetched line by an integer lane gather. With the "aligned" layout
    (default, see from_host) a run never straddles a line, so ONE line
    per node is fetched and the select examines 128 lanes; the
    "windowed" layout fetches WINDOW_LINES consecutive lines. Nodes
    whose run exceeds the line/window go through a compacted per-edge
    tail whose static size is the graph-wide count of such nodes —
    exact because frontiers are deduped, so each can appear at most
    once. Draws are bit-identical to sample_neighbors_per_edge.
    """
    if graph.big_deg_count < 0 or graph.indices.shape[0] % 128 != 0:
        return sample_neighbors_per_edge(key, graph, frontier, fanout)

    p = frontier.shape[0]
    if graph.lined:
        # ONE descriptor per node: the line index is the node id and the
        # degree rides in lane 127, so there is no meta-row gather at
        # all (the aligned layout's remaining second descriptor).
        valid = frontier >= 0
        ids = jnp.where(valid, frontier, 0)
        win = jnp.take(graph.indices.reshape(-1, 128), ids, axis=0)
        deg = win[:, 127]
        draw = _draws(key, deg, p, fanout)
        nbr = _select_lanes(win, jnp.minimum(draw, 126))
        tail_cap = min(p, (graph.big_deg_count + 7) // 8 * 8)
        if tail_cap > 0:
            assert graph.meta is not None and \
                graph.tail_indices is not None, (
                    "lined DeviceGraph with big_deg_count > 0 needs meta "
                    "and tail_indices (from_host builds both)")
            t = valid & (deg > 127)
            tpos = jnp.cumsum(t.astype(jnp.int32)) - 1
            tidx = jnp.where(t, jnp.minimum(tpos, tail_cap - 1), tail_cap)
            tids = jnp.zeros((tail_cap,), jnp.int32).at[tidx].set(
                ids, mode="drop")
            tstart = graph.meta[tids][:, 0]     # meta rows: tail only
            tdraw = jnp.zeros((tail_cap, fanout), jnp.int32).at[tidx].set(
                draw, mode="drop")
            taddr = tstart[:, None] + tdraw
            tnbr = graph.tail_indices[jnp.clip(
                taddr, 0, graph.tail_indices.shape[0] - 1)]
            back = jnp.take(tnbr, jnp.clip(tpos, 0, tail_cap - 1), axis=0)
            nbr = jnp.where(t[:, None], back, nbr)
        slot = jax.lax.broadcasted_iota(jnp.int32, (p, fanout), 1)
        ok = valid[:, None] & (slot < deg[:, None]) & (deg[:, None] > 0)
        return jnp.where(ok, nbr, -1)

    aligned = graph.astart is not None
    lanes = 128 if aligned else WINDOW_LINES * 128
    valid = frontier >= 0
    ids = jnp.where(valid, frontier, 0)
    start, deg = graph.node_meta(ids)
    draw = _draws(key, deg, p, fanout)

    indices2d = graph.indices.reshape(-1, 128)
    line0 = start >> 7
    if aligned:
        # aligned layout: any run with deg <= 128 sits inside ONE line
        win = jnp.take(indices2d, line0, axis=0)    # (P, 128)
    else:
        lidx = line0[:, None] + jnp.arange(WINDOW_LINES, dtype=jnp.int32)
        win = jnp.take(indices2d, lidx, axis=0).reshape(p, lanes)
    off = (start & 127)[:, None] + draw             # < lanes iff covered
    nbr = _select_lanes(win, jnp.minimum(off, lanes - 1))

    tail_cap = min(p, (graph.big_deg_count + 7) // 8 * 8)
    if tail_cap > 0:
        covered = (deg <= 128 if aligned
                   else (start & 127) + deg <= lanes)
        t = valid & jnp.logical_not(covered)
        tpos = jnp.cumsum(t.astype(jnp.int32)) - 1
        tidx = jnp.where(t, jnp.minimum(tpos, tail_cap - 1), tail_cap)
        tstart = jnp.zeros((tail_cap,), jnp.int32).at[tidx].set(
            start, mode="drop")
        tdraw = jnp.zeros((tail_cap, fanout), jnp.int32).at[tidx].set(
            draw, mode="drop")
        taddr = tstart[:, None] + tdraw
        tnbr = graph.indices[jnp.clip(taddr, 0,
                                      graph.indices.shape[0] - 1)]
        back = jnp.take(tnbr, jnp.clip(tpos, 0, tail_cap - 1), axis=0)
        nbr = jnp.where(t[:, None], back, nbr)

    slot = jax.lax.broadcasted_iota(jnp.int32, (p, fanout), 1)
    ok = valid[:, None] & (slot < deg[:, None]) & (deg[:, None] > 0)
    return jnp.where(ok, nbr, -1)


def grow_frontier(frontier_prev: jnp.ndarray, num_prev: jnp.ndarray,
                  neighbors: jnp.ndarray, cap_new: int
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, Block]:
    """Dedup the sampled hop and extend the frontier, preserving prefix
    numbering. Pure-functional replacement of the reference's atomic
    bitmap + position_map (``src/Kernels.cu:412-438``).

    Algorithm (sort-based, without jnp.unique's index/inverse machinery
    or searchsorted's scan lowering): one stable
    (id, origin) sort of [prev | neighbors], then segmented propagation
    over equal-id groups:

    * stability puts each id's prev-frontier occurrence (if any) first
      in its group, and its origin index IS its existing position;
    * group leaders that are not prev occurrences are brand-new ids,
      ranked by cumsum => appended positions in sorted-id order;
    * positions broadcast to group members with a cummax (positions are
      nonnegative, groups contiguous), and one scatter returns them to
      edge order.

    Returns (frontier_new (cap_new,), num_new (), block).
    """
    p, fanout = neighbors.shape
    prev_cap = frontier_prev.shape[0]
    prev_s = jnp.where(frontier_prev >= 0, frontier_prev, SENTINEL)
    nbr_s = jnp.where(neighbors >= 0, neighbors, SENTINEL).reshape(-1)
    cat = jnp.concatenate([prev_s, nbr_s])
    total = cat.shape[0]

    orig = jnp.arange(total, dtype=jnp.int32)
    # lexicographic (id, orig) == stable-by-id (orig is unique and
    # ascending within a group reproduces input order), but num_keys=2
    # avoids the THIRD operand XLA's stable-sort lowering adds (a hidden
    # iota tiebreak array riding every compare-exchange pass)
    s, sorig = jax.lax.sort([cat, orig], num_keys=2)

    valid_s = s != SENTINEL
    first = valid_s & jnp.concatenate(
        [jnp.ones((1,), bool), s[1:] != s[:-1]])
    old_first = first & (sorig < prev_cap)
    new_first = first & (sorig >= prev_cap)

    new_rank = jnp.cumsum(new_first.astype(jnp.int32)) - 1
    num_new_total = (num_prev
                     + jnp.sum(new_first.astype(jnp.int32))).astype(jnp.int32)

    pos_at_first = jnp.where(old_first, sorig,
                             num_prev + new_rank).astype(jnp.int32)

    # segmented broadcast leader->group: associative "last leader wins"
    # scan (old positions are NOT monotonic in sorted-id order, so a
    # plain cummax would leak a larger earlier position into the next
    # group — the flag carries "have seen a leader yet").
    def seg_copy(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    pos_sorted, _ = jax.lax.associative_scan(
        seg_copy, (jnp.where(first, pos_at_first, 0), first))

    # back to original order: un-sort by sorting (sorig, pos_sorted) on
    # the origin index rather than scattering.
    _, pos_orig = jax.lax.sort([sorig, pos_sorted], num_keys=1)
    nbr_pos = pos_orig[prev_cap:].reshape(p, fanout)

    # frontier: prev prefix + new ids at their appended positions.
    # Built by SORTING (id, target-position) rather than scattering.
    # First occurrences carry distinct in-range targets (old:
    # their prev index < num_prev; new: num_prev+rank), everything else
    # sorts to the tail as cap_new and yields the -1 padding.
    target = jnp.where(first & (pos_at_first < cap_new),
                       pos_at_first, cap_new)
    fval = jnp.where(target < cap_new, s, -1)
    if total < cap_new:  # degenerate caps: pad so the slice below is full
        target = jnp.concatenate(
            [target, jnp.full((cap_new - total,), cap_new, jnp.int32)])
        fval = jnp.concatenate(
            [fval, jnp.full((cap_new - total,), -1, jnp.int32)])
    _, frontier_new = jax.lax.sort([target, fval], num_keys=1)
    frontier_new = frontier_new[:cap_new]

    nbr_mask = neighbors >= 0
    block = Block(
        nbr_pos=jnp.where(nbr_mask, nbr_pos, 0).astype(jnp.int32),
        nbr_mask=nbr_mask,
        num_src=num_new_total,
        num_dst=num_prev.astype(jnp.int32),
    )
    return frontier_new, num_new_total, block


def append_frontier(frontier_prev: jnp.ndarray, num_prev: jnp.ndarray,
                    neighbors: jnp.ndarray, cap_new: int
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, Block]:
    """Grow the frontier WITHOUT dedup: every sampled (dst, slot) edge gets
    its own appended src row (invalid slots leave -1 holes).

    Used for the LAST hop with HBM-resident features, where the dedup
    sorts cost more than the duplicate feature-row gathers they avoid —
    and with the identity layout the first model layer's aggregation
    becomes a contiguous reshape instead of a 1.4M-row random gather.
    The reference has no analog (its dedup exists to save PCIe bytes,
    ``src/Kernels.cu:412-421``; the cached/host-feature path here keeps
    dedup for exactly that reason — see CachedTrainer).

    cap_new must equal prev_cap + dst_cap*fanout (exact, static).
    Returns (frontier_new, num_new=extent, block with identity_offset).
    """
    p, fanout = neighbors.shape
    prev_cap = frontier_prev.shape[0]
    assert cap_new == prev_cap + p * fanout, (
        f"append cap {cap_new} != {prev_cap} + {p}*{fanout}")
    nbr_mask = neighbors >= 0
    frontier_new = jnp.concatenate(
        [frontier_prev, jnp.where(nbr_mask, neighbors, -1).reshape(-1)])
    extent = jnp.full((), cap_new, jnp.int32)
    nbr_pos = (prev_cap
               + jax.lax.broadcasted_iota(jnp.int32, (p, fanout), 0) * fanout
               + jax.lax.broadcasted_iota(jnp.int32, (p, fanout), 1))
    block = Block(nbr_pos=nbr_pos, nbr_mask=nbr_mask,
                  num_src=extent, num_dst=num_prev.astype(jnp.int32),
                  identity_offset=prev_cap)
    return frontier_new, extent, block


def grow_frontier_scatter(frontier_prev: jnp.ndarray, num_prev: jnp.ndarray,
                          neighbors: jnp.ndarray, cap_new: int,
                          pos_map: jnp.ndarray, stamp: jnp.ndarray,
                          stamp_val: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray, Block,
                                     jnp.ndarray, jnp.ndarray]:
    """Sort-free dedup using a dense position map — the reference's own
    structure (``position_map[N]``, ``src/Server.cu:222``,
    ``src/Kernels.cu:434-438``) made functional: CUDA atomics become a
    scatter-min winner election, and per-batch bitmap clearing becomes a
    stamp comparison (``stamp[id] == stamp_val``) so no O(N) clear is
    needed between batches.

    Requires carried state (pos_map, stamp: (N,) int32). Before hop 1
    the caller must stamp the seeds (see sample_batch). New nodes are
    appended in edge order (not sorted id order) — same contract
    otherwise as grow_frontier.

    Returns (frontier_new, num_new, block, pos_map, stamp).
    """
    p, fanout = neighbors.shape
    n = pos_map.shape[0]
    e = p * fanout
    ids = neighbors.reshape(-1)
    valid = ids >= 0
    safe = jnp.where(valid, ids, 0)

    is_old = valid & (stamp[safe] == stamp_val)
    cand = valid & jnp.logical_not(is_old)

    # winner election: lowest edge index per new id
    eidx = jnp.arange(e, dtype=jnp.int32)
    scratch = jnp.full((n,), jnp.iinfo(jnp.int32).max, jnp.int32)
    scratch = scratch.at[jnp.where(cand, safe, n)].min(eidx, mode="drop")
    winner = cand & (scratch[safe] == eidx)

    new_rank = jnp.cumsum(winner.astype(jnp.int32)) - 1
    newpos = (num_prev + new_rank).astype(jnp.int32)
    num_new = (num_prev + jnp.sum(winner.astype(jnp.int32))).astype(jnp.int32)

    widx = jnp.where(winner, safe, n)
    pos_map = pos_map.at[widx].set(newpos, mode="drop")
    stamp = stamp.at[widx].set(stamp_val, mode="drop")

    frontier_new = jnp.full((cap_new,), -1, jnp.int32)
    frontier_new = frontier_new.at[: frontier_prev.shape[0]].set(frontier_prev)
    frontier_new = frontier_new.at[
        jnp.where(winner, jnp.minimum(newpos, cap_new - 1), cap_new)
    ].set(jnp.where(winner, ids, -1), mode="drop")

    nbr_pos = pos_map[safe].reshape(p, fanout)
    nbr_mask = neighbors >= 0
    block = Block(
        nbr_pos=jnp.where(nbr_mask, nbr_pos, 0).astype(jnp.int32),
        nbr_mask=nbr_mask, num_src=num_new, num_dst=num_prev.astype(jnp.int32))
    return frontier_new, num_new, block, pos_map, stamp


def sample_batch(key: jax.Array, graph: DeviceGraph, seeds: jnp.ndarray,
                 num_seeds: jnp.ndarray, labels: jnp.ndarray,
                 fanouts: Sequence[int],
                 caps: Sequence[int] | None = None,
                 dedup_last: bool = True) -> SampledBatch:
    """Full multi-hop sampling of one mini-batch (one jitted call).

    seeds: (seed_cap,) int32 padded with -1; ids must be unique within the
    batch (the reference guarantees this: batches are contiguous chunks of
    a node-id set, ``src/Kernels.cu:68-96``).

    Equivalent to the reference per-batch op chain BatchGenerator ->
    (RandomSampler x hops) -> construct_graph (``src/Server.cu:198-207``),
    minus feature extraction which is a separate stage (cache subsystem).

    dedup_last=False skips dedup on the final hop (see append_frontier) —
    the fast path for HBM-resident features; requires
    caps[-1] == caps[-2] * (1 + fanouts[-1]) exactly.
    """
    if caps is None:
        caps = frontier_caps(seeds.shape[0], fanouts)
    assert caps[0] >= seeds.shape[0]

    frontier = jnp.full((caps[0],), -1, jnp.int32).at[: seeds.shape[0]].set(seeds)
    num = num_seeds.astype(jnp.int32)
    blocks = []
    for k, fanout in enumerate(fanouts):
        key, sub = jax.random.split(key)
        nbrs = sample_neighbors(sub, graph, frontier, fanout)
        if k == len(fanouts) - 1 and not dedup_last:
            frontier, num, blk = append_frontier(frontier, num, nbrs,
                                                 caps[k + 1])
        else:
            frontier, num, blk = grow_frontier(frontier, num, nbrs,
                                               caps[k + 1])
        blocks.append(blk)

    return SampledBatch(
        seeds=seeds, labels=labels, num_seeds=num_seeds.astype(jnp.int32),
        frontier=frontier, num_frontier=num, blocks=tuple(blocks))


def sample_batch_scatter(key: jax.Array, graph: DeviceGraph,
                         seeds: jnp.ndarray, num_seeds: jnp.ndarray,
                         labels: jnp.ndarray, fanouts: Sequence[int],
                         caps: Sequence[int], pos_map: jnp.ndarray,
                         stamp: jnp.ndarray, stamp_val: jnp.ndarray):
    """sample_batch variant using the dense-position-map dedup
    (grow_frontier_scatter). pos_map/stamp are (num_nodes,) int32 carried
    across steps (donate them); stamp_val must be unique per batch
    (e.g. step+1; 0 is reserved for the initial stamp fill).

    Returns (SampledBatch, pos_map, stamp).
    """
    caps = tuple(caps)
    n = pos_map.shape[0]
    valid = seeds >= 0
    sidx = jnp.where(valid, seeds, n)
    pos_map = pos_map.at[sidx].set(
        jnp.arange(seeds.shape[0], dtype=jnp.int32), mode="drop")
    stamp = stamp.at[sidx].set(stamp_val, mode="drop")

    frontier = jnp.full((caps[0],), -1, jnp.int32).at[: seeds.shape[0]].set(seeds)
    num = num_seeds.astype(jnp.int32)
    blocks = []
    for k, fanout in enumerate(fanouts):
        key, sub = jax.random.split(key)
        nbrs = sample_neighbors(sub, graph, frontier, fanout)
        frontier, num, blk, pos_map, stamp = grow_frontier_scatter(
            frontier, num, nbrs, caps[k + 1], pos_map, stamp, stamp_val)
        blocks.append(blk)

    batch = SampledBatch(
        seeds=seeds, labels=labels, num_seeds=num_seeds.astype(jnp.int32),
        frontier=frontier, num_frontier=num, blocks=tuple(blocks))
    return batch, pos_map, stamp


def gather_features(features: jnp.ndarray, frontier: jnp.ndarray,
                    mask_invalid: bool = True,
                    out_dtype: jnp.dtype | None = None) -> jnp.ndarray:
    """Gather feature rows for a (padded) frontier from an HBM-resident
    table; padded slots read row 0 and (by default) are zeroed. The
    cached/host paths live in legion.cache.feature_cache.

    mask_invalid=False skips the zeroing — a whole extra HBM pass over
    the largest array in the step. Safe whenever every downstream
    consumer masks: all aggregators multiply by nbr_mask, and the
    loss/accuracy mask invalid seed rows, so the training/eval steps
    qualify (see train.loop).

    out_dtype: emit gathered rows in this dtype (a convert XLA may not
    fuse into its gather, i.e. a possible extra pass). Kept for callers
    whose consumers genuinely need a different dtype materialized
    once."""
    valid = frontier >= 0
    rows = features[jnp.where(valid, frontier, 0)]
    if out_dtype is not None and rows.dtype != out_dtype:
        rows = rows.astype(out_dtype)
    if mask_invalid:
        rows = rows * valid[:, None].astype(rows.dtype)
    return rows
