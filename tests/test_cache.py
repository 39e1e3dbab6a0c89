"""Cache subsystem tests: hotness measurement, cost-model math, feature
cache hit/miss correctness, topo cache sampling (SURVEY.md §7 step 5)."""

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.cost_model import solve_cost_model
from legion.cache.feature_cache import FeatureCache
from legion.cache.hotness import observed_caps, presample_hotness
from legion.cache.topo_cache import TopoCache, host_sample_cold
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph


def test_presample_hotness_counts(small_graph):
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    b, fanouts = 64, (5, 3)
    caps = frontier_caps(b, fanouts)
    ids = np.asarray(small_graph.train_ids)
    steps = 10
    seeds = np.stack([ids[i * b:(i + 1) * b] for i in range(steps)]).astype(np.int32)
    res = presample_hotness(
        jax.random.PRNGKey(0), g, jnp.asarray(seeds),
        jnp.full((steps,), b, jnp.int32), fanouts, caps,
        small_graph.num_nodes)
    node_hot = np.asarray(res.node_hot)
    edge_hot = np.asarray(res.edge_hot)
    # every seed is in its batch frontier => node_hot >= its seed count
    for s in seeds[0][:20]:
        assert node_hot[s] >= 1
    # seeds' rows are read at every hop => edge_hot >= hops per occurrence
    assert (edge_hot[seeds.reshape(-1)] >= 2).all()
    assert int(res.max_frontier) <= caps[-1]
    # hotness skew exists on a power-law graph
    assert node_hot.max() > np.median(node_hot)
    # per-hop maxima are achievable caps
    tight = observed_caps(res.max_per_hop, slack=1.2)
    assert len(tight) == 3 and tight[0] >= b


def test_cost_model_extremes():
    n = 100
    node_hot = np.zeros(n, np.int64)
    edge_hot = np.zeros(n, np.int64)
    node_hot[:10] = 100          # only features are hot
    degrees = np.full(n, 10)
    plan = solve_cost_model(node_hot, edge_hot, degrees,
                            budget_bytes=10 * 400, feat_row_bytes=400)
    # all budget should go to features (alpha ~ 0)
    assert plan.feat_capacity >= 10
    assert plan.saved_feat_bytes > 0 and plan.saved_topo_bytes == 0
    assert set(plan.feat_order[:10]) == set(range(10))

    plan2 = solve_cost_model(edge_hot, node_hot, degrees,
                             budget_bytes=10 * 400, feat_row_bytes=400)
    # symmetric: all budget to topology
    assert plan2.topo_capacity >= 10
    assert plan2.saved_topo_bytes > 0


def test_cost_model_placement_blindness_fixed():
    """Regression: with HBM-resident topology a topo
    cache saves zero host bytes, so even overwhelming edge hotness must
    not divert budget — alpha == 0 and the feature capacity is the full
    budget's worth of rows."""
    rng = np.random.default_rng(1)
    n = 4096
    # correlated power-law hotness: edges even hotter than features —
    # the exact shape that diverted ~38% of the budget pre-fix
    node_hot = rng.zipf(1.3, n).astype(np.int64)
    edge_hot = node_hot * 50
    degrees = np.full(n, 50)
    row_bytes = 400
    budget = 1024 * row_bytes
    plan = solve_cost_model(node_hot, edge_hot, degrees, budget,
                            feat_row_bytes=row_bytes,
                            topo_cacheable=False)
    assert plan.alpha == 0.0
    assert plan.topo_capacity == 0
    assert plan.feat_capacity == 1024        # FULL budget to features
    assert plan.saved_topo_bytes == 0.0
    # sanity: same inputs with a cacheable topology DO divert budget
    both = solve_cost_model(node_hot, edge_hot, degrees, budget,
                            feat_row_bytes=row_bytes)
    assert both.alpha > 0.0 and both.feat_capacity < 1024
    # symmetric: HBM-resident features => all budget to topology
    sym = solve_cost_model(node_hot, edge_hot, degrees, budget,
                           feat_row_bytes=row_bytes,
                           feat_cacheable=False)
    assert sym.alpha == 1.0 and sym.feat_capacity == 0
    assert sym.saved_feat_bytes == 0.0 and sym.topo_capacity > 0


def test_cost_model_split_prefers_hotter_side():
    rng = np.random.default_rng(0)
    n = 1000
    node_hot = rng.zipf(1.5, n).astype(np.int64)
    edge_hot = np.ones(n, np.int64)
    degrees = np.full(n, 5)
    plan = solve_cost_model(node_hot, edge_hot, degrees,
                            budget_bytes=100 * 64, feat_row_bytes=64)
    # feature side dominates savings => most budget to features
    assert plan.alpha < 0.5
    # order is hotness-descending
    nh = node_hot[plan.feat_order]
    assert (np.diff(nh) <= 0).all()


def test_feature_cache_hit_miss_roundtrip(small_graph):
    feats = np.asarray(small_graph.features)
    hot_order = np.argsort(-np.arange(feats.shape[0]))  # ids desc as "hotness"
    cache = FeatureCache.build(feats, hot_order, capacity=500, miss_cap=64)

    frontier = np.array([1999, 1500, 3, 7, -1, 1501], np.int32)  # 3 hits, 2 miss
    plan = jax.jit(cache.plan)(jnp.asarray(frontier))
    assert int(plan.num_hit) == 3
    assert int(plan.num_miss) == 2
    miss_ids = np.asarray(plan.miss_ids)
    assert set(miss_ids[:2].tolist()) == {3, 7}
    assert (miss_ids[2:] == -1).all()

    staged = cache.stage(miss_ids)
    x = np.asarray(jax.jit(cache.combine)(plan, jnp.asarray(staged),
                                          jnp.asarray(frontier)))
    for i, fid in enumerate(frontier):
        want = feats[fid] if fid >= 0 else np.zeros(feats.shape[1])
        np.testing.assert_allclose(x[i], want, rtol=1e-6)


def test_feature_cache_hit_rate_on_skewed_traffic(small_graph):
    """On power-law traffic, caching by true hotness yields high hit
    rate — the property the whole subsystem exists for."""
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    b, fanouts = 64, (5, 3)
    caps = frontier_caps(b, fanouts)
    ids = np.asarray(small_graph.train_ids)
    seeds = np.stack([ids[i * b:(i + 1) * b] for i in range(10)]).astype(np.int32)
    res = presample_hotness(jax.random.PRNGKey(0), g, jnp.asarray(seeds),
                            jnp.full((10,), b, jnp.int32), fanouts, caps,
                            small_graph.num_nodes)
    order = np.argsort(-np.asarray(res.node_hot), kind="stable")
    feats = np.asarray(small_graph.features)
    cache = FeatureCache.build(feats, order, capacity=600, miss_cap=caps[-1])

    from legion.sampling.sampler import sample_batch
    batch = sample_batch(jax.random.PRNGKey(99), g, jnp.asarray(seeds[0]),
                         jnp.full((), b, jnp.int32),
                         jnp.zeros((b,), jnp.int32), fanouts, caps)
    plan = cache.plan(batch.frontier)
    rate = float(plan.num_hit) / float(plan.num_valid)
    assert rate > 0.5, f"hit rate {rate} too low for 30% capacity"


def test_topo_cache_matches_full_graph(small_graph):
    indptr, indices = np.asarray(small_graph.indptr), np.asarray(small_graph.indices)
    hot_order = np.argsort(-np.diff(indptr))  # cache high-degree nodes
    tc = TopoCache.build(indptr, indices, hot_order.astype(np.int32), 300)

    frontier = np.concatenate([hot_order[:5], hot_order[-5:], [-1]]).astype(np.int32)
    nbrs, hit = jax.jit(tc.sample_hot, static_argnums=(2,))(
        jax.random.PRNGKey(0), jnp.asarray(frontier), 4)
    nbrs, hit = np.asarray(nbrs), np.asarray(hit)
    assert hit[:5].all() and not hit[5:].any()
    for i in range(5):
        v = frontier[i]
        true_set = set(indices[indptr[v]:indptr[v + 1]].tolist())
        for x in nbrs[i]:
            if x >= 0:
                assert x in true_set
    # cold path on host
    cold = host_sample_cold(indptr, indices,
                            np.where(hit, -1, frontier), 4,
                            np.random.default_rng(0))
    for i in range(5, 10):
        v = frontier[i]
        true_nbrs = set(indices[indptr[v]:indptr[v + 1]].tolist())
        deg = indptr[v + 1] - indptr[v]
        for s, x in enumerate(cold[i]):
            if s < min(deg, 4) and deg > 0:
                assert x in true_nbrs


def test_cache_plan_staging_overflow():
    """Misses beyond miss_cap are reported as overflow and their rows
    combine to zero (not garbage)."""
    import jax.numpy as jnp
    import numpy as np
    from legion.cache.feature_cache import FeatureCache
    feats = np.arange(40, dtype=np.float32).reshape(10, 4) + 1.0
    # cache holds rows {0, 1}; frontier has 4 misses but miss_cap=2
    cache = FeatureCache.build(feats, np.array([0, 1]), capacity=2,
                               miss_cap=2)
    frontier = jnp.asarray(np.array([0, 5, 6, 7, 8, 1, -1], np.int32))
    plan = cache.plan(frontier)
    assert int(plan.num_miss) == 4
    assert int(plan.overflow()) == 2
    staged = cache.stage(np.asarray(plan.miss_ids))
    x = np.asarray(cache.combine(plan, jnp.asarray(staged), frontier))
    np.testing.assert_allclose(x[0], feats[0])   # hit
    np.testing.assert_allclose(x[1], feats[5])   # staged miss 0
    np.testing.assert_allclose(x[2], feats[6])   # staged miss 1
    np.testing.assert_allclose(x[3], 0.0)        # overflowed -> zero
    np.testing.assert_allclose(x[4], 0.0)        # overflowed -> zero
    np.testing.assert_allclose(x[5], feats[1])   # hit
    np.testing.assert_allclose(x[6], 0.0)        # padding
