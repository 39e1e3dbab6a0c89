"""StripedTopoCache: the hot sub-CSR striped over the cache axis.

Parity surface: hit mask == hot-set membership; every sampled neighbor
is a true neighbor of its frontier node; -1 sentinel semantics match the
device sampler; 1-chip striping is bit-identical to the single-chip
TopoCache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from legion.cache.striped import StripedTopoCache
from legion.cache.topo_cache import TopoCache
from legion.parallel.mesh import make_mesh


def _adj_sets(g):
    indptr = np.asarray(g.indptr)
    indices = np.asarray(g.indices)
    return indptr, indices


def _run_striped(mesh, topo, key, frontiers, fanout):
    """frontiers: (n_chips, M). Returns (nbrs (n, M, fanout), hit (n, M))."""
    def f(hot_ids, sp, si, key, frontier):
        nbr, hit = StripedTopoCache.sample_hot(hot_ids, sp, si, key,
                                               frontier[0], fanout)
        return nbr[None], hit[None]

    ax = P(("data", "cache"))
    jf = jax.jit(jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(), P("cache"), P("cache"), P(), ax),
        out_specs=(ax, ax)), static_argnums=())
    sh = NamedSharding(mesh, P(("data", "cache")))
    nbr, hit = jf(topo.hot_ids, topo.sub_indptr, topo.sub_indices,
                  jax.device_put(key, NamedSharding(mesh, P())),
                  jax.device_put(frontiers, sh))
    return np.asarray(nbr), np.asarray(hit)


@pytest.mark.parametrize("kg", [2, 4])
def test_striped_topo_sampling_valid(small_graph, rng, kg):
    mesh = make_mesh(4, cache_group_size=kg)
    indptr, indices = _adj_sets(small_graph)
    capacity = 600
    order = np.argsort(-np.diff(indptr)).astype(np.int32)  # hottest=densest
    topo = StripedTopoCache.build(indptr, indices, order, capacity, mesh)
    hot_set = set(np.asarray(topo.hot_ids).tolist())

    m, fanout = 64, 5
    frontiers = rng.integers(0, small_graph.num_nodes,
                             size=(4, m)).astype(np.int32)
    frontiers[:, -4:] = -1
    nbr, hit = _run_striped(mesh, topo, jax.random.PRNGKey(3),
                            frontiers, fanout)

    for c in range(4):
        for i in range(m):
            v = frontiers[c, i]
            expected_hit = v >= 0 and int(v) in hot_set
            assert bool(hit[c, i]) == expected_hit, (c, i, v)
            deg = int(indptr[v + 1] - indptr[v]) if v >= 0 else 0
            adj = set(indices[indptr[v]:indptr[v + 1]].tolist()) \
                if v >= 0 else set()
            for f in range(fanout):
                s = int(nbr[c, i, f])
                if not expected_hit or deg == 0 or f >= deg:
                    assert s == -1, (c, i, f, s)
                else:
                    assert s in adj, (c, i, f, s, "not a neighbor")


def test_striped_topo_k1_bit_matches_single_chip(small_graph, rng):
    """On a 1-chip mesh the striped draw matrix has the single-chip
    shape, so draws are bit-identical to TopoCache.sample_hot."""
    mesh = make_mesh(1, cache_group_size=1)
    indptr, indices = _adj_sets(small_graph)
    order = np.arange(small_graph.num_nodes, dtype=np.int32)
    capacity = 700
    st = StripedTopoCache.build(indptr, indices, order, capacity, mesh)
    tc = TopoCache.build(indptr, indices, order, capacity)

    m, fanout = 96, 4
    frontier = rng.integers(0, small_graph.num_nodes, size=m).astype(np.int32)
    frontier[-6:] = -1
    key = jax.random.PRNGKey(11)
    nbr_s, hit_s = _run_striped(mesh, st, key, frontier[None], fanout)
    nbr_t, hit_t = jax.jit(TopoCache.sample_hot, static_argnums=(3,))(
        tc, key, jnp.asarray(frontier), fanout)
    np.testing.assert_array_equal(nbr_s[0], np.asarray(nbr_t))
    np.testing.assert_array_equal(hit_s[0], np.asarray(hit_t))
