"""Sampler unit tests: determinism, sentinel semantics, dedup/renumber
invariants (SURVEY.md §4 planned pyramid)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legion.sampling.block import frontier_caps
from legion.sampling.sampler import (
    DeviceGraph, gather_features, grow_frontier, sample_batch, sample_neighbors)


def _dev_graph(g):
    return DeviceGraph.from_host(g.indptr, g.indices)


def test_sample_neighbors_semantics(tiny_chain):
    """Chain 0<-1<-...: node v's only in-neighbor is v+1; degree 1 so
    slot 0 always samples v+1, slots >=1 are -1 (slot >= degree rule,
    reference src/Kernels.cu:399-400). Last node has degree 0."""
    g = _dev_graph(tiny_chain)
    frontier = jnp.array([0, 3, 7, -1], jnp.int32)
    out = np.asarray(sample_neighbors(jax.random.PRNGKey(0), g, frontier, 3))
    assert out[0].tolist() == [1, -1, -1]
    assert out[1].tolist() == [4, -1, -1]
    assert out[2].tolist() == [-1, -1, -1]   # node 7: zero degree
    assert out[3].tolist() == [-1, -1, -1]   # padded source


def test_sampler_deterministic(small_graph):
    g = _dev_graph(small_graph)
    frontier = jnp.arange(64, dtype=jnp.int32)
    a = sample_neighbors(jax.random.PRNGKey(7), g, frontier, 5)
    b = sample_neighbors(jax.random.PRNGKey(7), g, frontier, 5)
    c = sample_neighbors(jax.random.PRNGKey(8), g, frontier, 5)
    assert (np.asarray(a) == np.asarray(b)).all()
    assert (np.asarray(a) != np.asarray(c)).any()


def test_sampled_ids_are_neighbors(small_graph):
    g = _dev_graph(small_graph)
    ids = np.unique(np.asarray(small_graph.train_ids)[:100]).astype(np.int32)
    frontier = jnp.asarray(ids)
    out = np.asarray(sample_neighbors(jax.random.PRNGKey(3), g, frontier, 10))
    indptr, indices = small_graph.indptr, small_graph.indices
    for i, v in enumerate(ids):
        nbrs = set(indices[indptr[v]:indptr[v + 1]].tolist())
        deg = len(indices[indptr[v]:indptr[v + 1]])
        for s, x in enumerate(out[i]):
            if s < min(deg, 10) and deg > 0:
                assert x in nbrs
            elif s >= deg:
                assert x == -1


def test_grow_frontier_prefix_and_dedup():
    """Hand-checkable dedup: frontier [10,20], neighbors contain dups,
    old ids, and invalid slots."""
    frontier = jnp.array([10, 20, -1, -1], jnp.int32)
    nbrs = jnp.array([[30, 10, 30], [20, 40, -1]], jnp.int32)
    fnew, num, blk = grow_frontier(frontier, jnp.int32(2), nbrs, 12)
    fnew = np.asarray(fnew)
    assert int(num) == 4
    # prefix preserved, new ids appended in sorted order
    assert fnew[:4].tolist() == [10, 20, 30, 40]
    assert (fnew[4:] == -1).all()
    pos = np.asarray(blk.nbr_pos)
    mask = np.asarray(blk.nbr_mask)
    assert mask.tolist() == [[True, True, True], [True, True, False]]
    assert pos[0].tolist() == [2, 0, 2]
    assert pos[1][:2].tolist() == [1, 3]
    assert int(blk.num_dst) == 2 and int(blk.num_src) == 4


def test_sample_batch_invariants(small_graph):
    g = _dev_graph(small_graph)
    b = 64
    fanouts = (5, 3)
    seeds_np = np.unique(np.asarray(small_graph.train_ids)[:b]).astype(np.int32)
    seeds = np.full((b,), -1, np.int32)
    seeds[:seeds_np.shape[0]] = seeds_np
    labels = np.where(seeds >= 0,
                      np.asarray(small_graph.labels)[np.clip(seeds, 0, None)], -1)
    batch = jax.jit(sample_batch, static_argnums=(5, 6))(
        jax.random.PRNGKey(0), g, jnp.asarray(seeds),
        jnp.full((), seeds_np.shape[0], jnp.int32), jnp.asarray(labels),
        fanouts, frontier_caps(b, fanouts))

    frontier = np.asarray(batch.frontier)
    nf = int(batch.num_frontier)
    # dense prefix of unique valid ids; -1 beyond
    assert (frontier[:nf] >= 0).all() and (frontier[nf:] == -1).all()
    assert len(set(frontier[:nf].tolist())) == nf
    # seeds occupy the prefix in original order
    assert frontier[:seeds_np.shape[0]].tolist() == seeds_np.tolist()

    # every valid edge's src position maps to a real node; dst prefix rule
    prev_valid = int(batch.num_seeds)
    for blk in batch.blocks:
        pos = np.asarray(blk.nbr_pos)
        mask = np.asarray(blk.nbr_mask)
        assert int(blk.num_dst) == prev_valid
        ns = int(blk.num_src)
        assert (pos[mask] < ns).all() and (pos[mask] >= 0).all()
        # dst slots with valid edges must be valid dst nodes
        rows = np.nonzero(mask.any(axis=1))[0]
        assert (rows < int(blk.num_dst)).all()
        prev_valid = ns
    assert prev_valid == nf


def test_edges_connect_true_neighbors(small_graph):
    """End-to-end renumbering check: decode block edges back to global ids
    and verify each is a real graph edge (construct_graph parity,
    reference src/Kernels.cu:450-463)."""
    g = _dev_graph(small_graph)
    b, fanouts = 32, (4, 4)
    seeds_np = np.unique(np.asarray(small_graph.train_ids)[:b]).astype(np.int32)
    seeds = np.full((b,), -1, np.int32)
    seeds[:seeds_np.shape[0]] = seeds_np
    batch = sample_batch(jax.random.PRNGKey(5), g, jnp.asarray(seeds),
                         jnp.full((), seeds_np.shape[0], jnp.int32),
                         jnp.zeros((b,), jnp.int32), fanouts,
                         frontier_caps(b, fanouts))
    indptr, indices = small_graph.indptr, small_graph.indices
    frontier = np.asarray(batch.frontier)
    # frontier of previous hop is a prefix of the final frontier
    for blk in batch.blocks:
        pos = np.asarray(blk.nbr_pos)
        mask = np.asarray(blk.nbr_mask)
        for d in range(pos.shape[0]):
            dst_gid = frontier[d]
            for f in range(pos.shape[1]):
                if mask[d, f]:
                    src_gid = frontier[pos[d, f]]
                    nbrs = indices[indptr[dst_gid]:indptr[dst_gid + 1]]
                    assert src_gid in nbrs


def test_gather_features(small_graph):
    feats = jnp.asarray(np.asarray(small_graph.features))
    frontier = jnp.array([3, 0, -1, 5], jnp.int32)
    out = np.asarray(gather_features(feats, frontier))
    np.testing.assert_allclose(out[0], small_graph.features[3])
    np.testing.assert_allclose(out[2], 0.0)


def test_append_frontier_identity_layout():
    from legion.sampling.sampler import append_frontier
    frontier = jnp.array([10, 20, -1, -1], jnp.int32)
    nbrs = jnp.array([[30, 10, 30], [20, 40, -1]], jnp.int32)
    fnew, num, blk = append_frontier(frontier, jnp.int32(2), nbrs, 10)
    fnew = np.asarray(fnew)
    assert int(num) == 10                        # extent, not count
    assert fnew[:4].tolist() == [10, 20, -1, -1]  # prefix untouched
    assert fnew[4:].tolist() == [30, 10, 30, 20, 40, -1]
    assert blk.identity_offset == 4
    pos = np.asarray(blk.nbr_pos)
    assert pos.tolist() == [[4, 5, 6], [7, 8, 9]]
    assert np.asarray(blk.nbr_mask).tolist() == [[True, True, True],
                                                 [True, True, False]]


def test_sample_batch_dedup_last_false_semantics(small_graph):
    """Same PRNG key => identical sampled multisets of (dst, neighbor)
    edges whether or not the last hop dedups; decoded global edges match."""
    g = _dev_graph(small_graph)
    b, fanouts = 32, (4, 3)
    caps = frontier_caps(b, fanouts)
    seeds_np = np.unique(np.asarray(small_graph.train_ids)[:b]).astype(np.int32)
    seeds = np.full((b,), -1, np.int32)
    seeds[:seeds_np.shape[0]] = seeds_np
    args = (jax.random.PRNGKey(11), g, jnp.asarray(seeds),
            jnp.full((), seeds_np.shape[0], jnp.int32),
            jnp.zeros((b,), jnp.int32), fanouts, caps)
    bd = sample_batch(*args, dedup_last=True)
    ba = sample_batch(*args, dedup_last=False)

    # hop-1 identical by construction
    assert (np.asarray(bd.blocks[0].nbr_pos) ==
            np.asarray(ba.blocks[0].nbr_pos)).all()

    def decoded(batch):
        frontier = np.asarray(batch.frontier)
        blk = batch.blocks[-1]
        pos, mask = np.asarray(blk.nbr_pos), np.asarray(blk.nbr_mask)
        return {(d, f): frontier[pos[d, f]]
                for d in range(pos.shape[0]) for f in range(pos.shape[1])
                if mask[d, f]}

    assert decoded(bd) == decoded(ba)
    # appended region of the no-dedup frontier is the raw neighbor grid
    blk = ba.blocks[-1]
    assert blk.identity_offset == caps[-2]
    f = np.asarray(ba.frontier)
    assert ba.frontier.shape[0] == caps[-2] + blk.dst_cap * blk.fanout
    assert (f[caps[-2]:][np.asarray(blk.nbr_mask).reshape(-1)] >= 0).all()


def test_line_layouts_match_per_edge(small_graph):
    """Line-granular sampling (aligned single-line layout AND the
    windowed 2-line layout) must be bit-identical to the per-edge gather
    for the same key — and to each other, since draws depend only on
    degrees, which layouts preserve."""
    from legion.sampling.sampler import sample_neighbors_per_edge
    gw = DeviceGraph.from_host(small_graph.indptr, small_graph.indices,
                               layout="windowed")
    ga = DeviceGraph.from_host(small_graph.indptr, small_graph.indices,
                               layout="aligned", aligned_max_expand=1e9)
    gl = DeviceGraph.from_host(small_graph.indptr, small_graph.indices,
                               layout="lined")
    assert ga.astart is not None and gw.astart is None
    assert gl.lined and gl.indices.shape[0] == 128 * gl.num_nodes
    frontier = jnp.asarray(
        np.r_[np.arange(200), [-1, -1]].astype(np.int32))
    for k in range(3):
        ref = sample_neighbors_per_edge(jax.random.PRNGKey(k), gw,
                                        frontier, 7)
        for g in (gw, ga, gl):
            a = sample_neighbors(jax.random.PRNGKey(k), g, frontier, 7)
            assert (np.asarray(a) == np.asarray(ref)).all()


def test_aligned_layout_midsize_runs_dont_straddle():
    """Regression: a (64 < deg <= 128) run preceded by an ODD number of
    64-slot runs must still start on a 128 boundary — a plain cumsum
    placement put it at offset % 128 == 64, straddling a line, and the
    covered-path select silently clamped draws to lane 127 (wrong
    neighbors). Mixed degrees 1..200 sweep, bit-identical to per-edge."""
    from legion.sampling.sampler import sample_neighbors_per_edge
    rng = np.random.default_rng(7)
    # deg=[10, 100]: the original reproducer; then a randomized sweep
    for deg in ([10, 100],
                rng.integers(1, 200, size=500).tolist(),
                [64, 65, 128, 129, 63, 1, 127, 66] * 8):
        deg = np.asarray(deg, np.int64)
        n = len(deg)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, n, size=indptr[-1]).astype(np.int32)
        g = DeviceGraph.from_host(indptr, indices, layout="aligned",
                                  aligned_max_expand=1e9)
        assert g.astart is not None
        sa = np.asarray(g.astart)
        straddle = (deg <= 128) & ((sa % 128) + deg > 128)
        assert not straddle.any(), np.where(straddle)[0][:5]
        frontier = jnp.asarray(np.r_[np.arange(n), [-1]].astype(np.int32))
        a = sample_neighbors(jax.random.PRNGKey(5), g, frontier, 64)
        b = sample_neighbors_per_edge(jax.random.PRNGKey(5), g,
                                      frontier, 64)
        assert (np.asarray(a) == np.asarray(b)).all()


def test_aligned_layout_expand_guard():
    """Low-degree graphs must fall back to windowed: 64-slot padding of
    degree-1 runs would cost up to 64x topology HBM."""
    n = 1000
    indptr = np.arange(n + 1, dtype=np.int64)        # every degree 1
    indices = np.zeros(n, np.int32)
    g = DeviceGraph.from_host(indptr, indices, layout="aligned")
    assert g.astart is None                          # fell back


def test_line_tail_path_exercised():
    """Graph with hub nodes beyond the window/line: tail fallback must
    still be bit-identical to per-edge sampling and big_deg_count must
    see the hubs — in both layouts."""
    from legion.sampling.sampler import sample_neighbors_per_edge
    rng = np.random.default_rng(0)
    n, hub_deg = 3000, 700
    # 5 hubs with deg 700 (> WINDOW_LINES*128-129 and > 128), rest ~20
    deg = rng.integers(1, 40, size=n)
    deg[:5] = hub_deg
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, size=indptr[-1]).astype(np.int32)
    frontier = jnp.asarray(np.r_[np.arange(5), rng.permutation(n)[:100],
                                 [-1]].astype(np.int32))
    for layout in ("windowed", "aligned", "lined"):
        g = DeviceGraph.from_host(indptr, indices, layout=layout)
        assert g.big_deg_count >= 5
        if layout == "lined":
            assert g.tail_indices is not None
        a = sample_neighbors(jax.random.PRNGKey(3), g, frontier, 9)
        b = sample_neighbors_per_edge(jax.random.PRNGKey(3), g,
                                      frontier, 9)
        assert (np.asarray(a) == np.asarray(b)).all()


def test_lined_auto_and_size_guard():
    """from_host("auto") picks lined under the byte budget and falls
    back to aligned/windowed beyond it; lined parity holds for a
    zero-big-degree graph (tail_indices elided entirely)."""
    from legion.sampling.sampler import sample_neighbors_per_edge
    rng = np.random.default_rng(2)
    n = 500
    deg = rng.integers(0, 30, size=n)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, size=indptr[-1]).astype(np.int32)
    g_auto = DeviceGraph.from_host(indptr, indices)          # auto
    assert g_auto.lined and g_auto.tail_indices is None
    g_cap = DeviceGraph.from_host(indptr, indices,
                                  lined_max_bytes=n * 512 - 1)
    assert not g_cap.lined
    frontier = jnp.asarray(np.r_[np.arange(n), [-1]].astype(np.int32))
    a = sample_neighbors(jax.random.PRNGKey(11), g_auto, frontier, 6)
    b = sample_neighbors_per_edge(jax.random.PRNGKey(11), g_auto,
                                  frontier, 6)
    c = sample_neighbors(jax.random.PRNGKey(11), g_cap, frontier, 6)
    assert (np.asarray(a) == np.asarray(b)).all()
    assert (np.asarray(a) == np.asarray(c)).all()


def test_select_lanes_large_ids():
    """The lane select must be exact for ids >= 2^24 over a two-line
    (256-lane) window."""
    from legion.sampling.sampler import _select_lanes
    rng = np.random.default_rng(1)
    win = rng.integers(0, 2**31 - 1, size=(64, 256)).astype(np.int32)
    off = rng.integers(0, 256, size=(64, 5)).astype(np.int32)
    out = np.asarray(_select_lanes(jnp.asarray(win), jnp.asarray(off)))
    want = np.take_along_axis(win, off, axis=1)
    assert (out == want).all()


@pytest.mark.parametrize("p", [300, 1024])
@pytest.mark.parametrize("lo,hi", [(0, 1 << 11), (1 << 11, 1 << 24),
                                   (1 << 24, (1 << 31) - 1)])
def test_select_lanes_exact(lo, hi, p):
    """The lane select is an integer gather: exact for ids below 2^11
    (where a TF32 float select would already round), up to 2^24 and
    beyond, at a row count that is no tile multiple."""
    from legion.sampling.sampler import _select_lanes
    rng = np.random.default_rng(lo % 97 + p)
    win = rng.integers(lo, hi, (p, 128), dtype=np.int64).astype(np.int32)
    off = rng.integers(0, 128, (p, 10)).astype(np.int32)
    got = np.asarray(jax.jit(_select_lanes)(jnp.asarray(win),
                                            jnp.asarray(off)))
    assert got.dtype == np.int32
    assert np.array_equal(got, np.take_along_axis(win, off, axis=1))
