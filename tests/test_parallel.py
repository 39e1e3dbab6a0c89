"""Multi-chip tests on the 8-device virtual CPU mesh: striped feature
exchange correctness and DP step parity with psum'd gradients."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
from legion.models import build_model
from legion.parallel.dp import make_dp_train_step, put_striped_features
from legion.parallel.feature_exchange import shard_rows, sharded_row_fetch
from legion.parallel.mesh import make_mesh
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph
from legion.train.train_state import create_train_state


def test_shard_rows_roundrobin():
    table = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    out = shard_rows(table, 4)
    assert out.shape == (4, 3, 3)
    np.testing.assert_array_equal(out[1, 0], table[1])
    np.testing.assert_array_equal(out[1, 1], table[5])
    np.testing.assert_array_equal(out[3, 2], 0.0)  # padded slot


def test_sharded_row_fetch_matches_dense():
    mesh = make_mesh(8, cache_group_size=4)
    k = 4
    n, d = 57, 16
    rng = np.random.default_rng(0)
    table = rng.standard_normal((n, d)).astype(np.float32)
    feats = put_striped_features(table, mesh)

    # per-(data,cache)-shard id requests, incl. -1 padding + dup ids
    ids = rng.integers(-1, n, size=(8, 12)).astype(np.int32)
    ids_flat = jnp.asarray(ids.reshape(-1))
    ids_sharded = jax.device_put(
        ids_flat, NamedSharding(mesh, P(("data", "cache"))))

    def f(feats_local, ids_local):
        return sharded_row_fetch(feats_local, ids_local, "cache")

    out = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("cache"), P(("data", "cache"))),
        out_specs=P(("data", "cache"))))(feats, ids_sharded)
    out = np.asarray(out).reshape(8, 12, d)
    for s in range(8):
        for j in range(12):
            want = table[ids[s, j]] if ids[s, j] >= 0 else np.zeros(d)
            np.testing.assert_allclose(out[s, j], want, rtol=1e-5, atol=1e-6)


def _setup(small_graph, sharded):
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0),
    )
    mesh = make_mesh(8, cache_group_size=2)
    graph = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    caps = frontier_caps(cfg.sampler.batch_size, cfg.sampler.fanouts)
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)
    feats_np = np.asarray(small_graph.features)
    if sharded:
        feats = put_striped_features(feats_np, mesh)
    else:
        feats = jnp.asarray(feats_np)
    return cfg, mesh, graph, caps, model, feats


def _init_params(model, small_graph, caps, cfg):
    import jax.random as jr
    from legion.sampling.sampler import gather_features, sample_batch
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    b = cfg.sampler.batch_size
    seeds = jnp.arange(b, dtype=jnp.int32)
    batch = sample_batch(jr.PRNGKey(0), g, seeds, jnp.full((), b, jnp.int32),
                         jnp.zeros((b,), jnp.int32),
                         tuple(cfg.sampler.fanouts), caps)
    x = gather_features(jnp.asarray(np.asarray(small_graph.features)),
                        batch.frontier)
    return model.init(jr.PRNGKey(0), tuple(reversed(batch.blocks)), x,
                      deterministic=True)["params"]


def test_dp_step_runs_and_syncs(small_graph):
    """8-way DP step: params stay replicated-identical, loss finite,
    global edge count ~8x a single shard's."""
    cfg, mesh, graph, caps, model, feats = _setup(small_graph, sharded=False)
    params = _init_params(model, small_graph, caps, cfg)
    state = create_train_state(params, 0.01, 0)

    total = 8 * cfg.sampler.batch_size
    seeds = np.random.default_rng(0).permutation(
        np.asarray(small_graph.train_ids))[:total].astype(np.int32)
    labels = np.asarray(small_graph.labels)[seeds]
    step, _ = make_dp_train_step(cfg, model, caps, mesh)
    s_sh = jax.device_put(jnp.asarray(seeds),
                          NamedSharding(mesh, P(("data", "cache"))))
    l_sh = jax.device_put(jnp.asarray(labels),
                          NamedSharding(mesh, P(("data", "cache"))))
    state2, metrics = step(state, graph, feats,
                           s_sh, jnp.full((), cfg.sampler.batch_size,
                                          jnp.int32), l_sh)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2.step) == 1
    # edges: 8 shards x (<= 32*4 + 160*3) but > single-shard minimum
    assert int(metrics["edges"]) > 8 * 32 * 2


def test_dp_sharded_features_matches_replicated(small_graph):
    """Same seeds, same params: striped-feature DP step must produce the
    same loss and updated params as the replicated-feature step."""
    cfg, mesh, graph, caps, model, feats_rep = _setup(small_graph, False)
    _, _, _, _, _, feats_sh = _setup(small_graph, True)
    params = _init_params(model, small_graph, caps, cfg)

    total = 8 * cfg.sampler.batch_size
    seeds = np.random.default_rng(1).permutation(
        np.asarray(small_graph.train_ids))[:total].astype(np.int32)
    labels = np.asarray(small_graph.labels)[seeds]
    sh = NamedSharding(mesh, P(("data", "cache")))
    s_sh = jax.device_put(jnp.asarray(seeds), sh)
    l_sh = jax.device_put(jnp.asarray(labels), sh)
    nb = jnp.full((), cfg.sampler.batch_size, jnp.int32)

    step_rep, _ = make_dp_train_step(cfg, model, caps, mesh,
                                     sharded_features=False)
    step_shd, _ = make_dp_train_step(cfg, model, caps, mesh,
                                     sharded_features=True)
    # independent copies: the jitted steps donate their state buffers
    st1 = create_train_state(jax.tree_util.tree_map(jnp.copy, params), 0.01, 0)
    st2 = create_train_state(jax.tree_util.tree_map(jnp.copy, params), 0.01, 0)
    out1, m1 = step_rep(st1, graph, feats_rep, s_sh, nb, l_sh)
    out2, m2 = step_shd(st2, graph, feats_sh, s_sh, nb, l_sh)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(out1.params),
                    jax.tree_util.tree_leaves(out2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_exact_fetch_matches_dense_all_group_sizes():
    """The exact (route-by-owner all_to_all) exchange returns the same
    rows as a dense lookup for every group size, with -1 padding and
    duplicate ids, and counts zero overflow at uniform ownership."""
    from legion.parallel.feature_exchange import sharded_row_fetch_stats
    rng = np.random.default_rng(3)
    n, d, m = 500, 8, 64
    table = rng.standard_normal((n, d)).astype(np.float32)
    for k in (1, 2, 8):
        mesh = make_mesh(k, cache_group_size=k)
        feats = put_striped_features(table, mesh)
        ids = np.where(rng.random((k, m)) < 0.7,
                       rng.integers(0, n, (k, m)), -1).astype(np.int32)
        dup = rng.integers(0, n)
        ids[:, :4] = dup                      # duplicates across chips
        ids_sh = jax.device_put(jnp.asarray(ids.reshape(-1)),
                                NamedSharding(mesh, P("cache")))

        def f(rl, il):
            o, ov = sharded_row_fetch_stats(rl, il, "cache")
            return o, ov[None]

        out, ov = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("cache"), P("cache")),
            out_specs=(P("cache"), P("cache"))))(feats, ids_sh)
        assert int(np.asarray(ov).sum()) == 0
        out = np.asarray(out).reshape(k, m, d)
        want = np.where(ids[..., None] >= 0,
                        table[np.clip(ids, 0, None)], 0.0)
        np.testing.assert_allclose(out, want, rtol=1e-6)


def test_exact_fetch_overflow_counted_and_zeroed():
    """Adversarial skew (every request owned by chip 0): requests beyond
    the per-owner cap return ZERO rows and are COUNTED — the static-cap
    + overflow-metric contract."""
    from legion.parallel.feature_exchange import (
        owner_cap, sharded_row_fetch_stats)
    k, n, d, m = 4, 400, 8, 64
    mesh = make_mesh(k, cache_group_size=k)
    table = np.arange(n * d, dtype=np.float32).reshape(n, d)
    feats = put_striped_features(table, mesh)
    ids = ((np.arange(k * m, dtype=np.int32) * k) % n)  # all owner 0
    ids_sh = jax.device_put(jnp.asarray(ids),
                            NamedSharding(mesh, P("cache")))

    def f(rl, il):
        o, ov = sharded_row_fetch_stats(rl, il, "cache")
        return o, ov[None]

    out, ov = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("cache"), P("cache")),
        out_specs=(P("cache"), P("cache"))))(feats, ids_sh)
    cap = owner_cap(m, k)
    assert np.asarray(ov).tolist() == [m - cap] * k
    out = np.asarray(out).reshape(k, m, d)
    want = table[ids.reshape(k, m)]
    np.testing.assert_allclose(out[:, :cap], want[:, :cap])
    assert (out[:, cap:] == 0).all()


def test_striped_plan_demotes_overflow_to_misses():
    """StripedFeatureCache.plan_ids(k>1): hits beyond the exchange cap
    become host-staged misses — correct under any skew, never zero rows
    (the feature-path self-healing contract)."""
    from legion.cache.striped import StripedFeatureCache
    # hot ranks 0..63, all with rank % 4 == 0 -> all owned by chip 0
    m, k, miss_cap = 64, 4, 64
    hot = jnp.arange(0, 256, 1, dtype=jnp.int32)
    frontier = jnp.asarray((np.arange(m) * 4).astype(np.int32))  # ids
    # ids 0,4,8,... are hot ranks 0,4,8,... (hot = identity here), all
    # rank % 4 == 0
    base = StripedFeatureCache.plan_ids(hot, frontier, miss_cap)
    assert int(base.num_hit) == m
    plan = StripedFeatureCache.plan_ids(hot, frontier, miss_cap, k=k)
    from legion.parallel.feature_exchange import owner_cap
    cap = owner_cap(m, k)
    assert int(plan.num_hit) == cap
    assert int(plan.num_miss) == m - cap
    # demoted ids staged for the host
    staged_ids = np.asarray(plan.miss_ids)
    assert (staged_ids[: m - cap] >= 0).all()
