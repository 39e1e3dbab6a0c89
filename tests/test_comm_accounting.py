"""Quantitative comm accounting: the closed-form
per-step collective volumes are asserted against the collectives
ACTUALLY PRESENT in the compiled HLO of each exchange/step program —
converting the core-starved virtual-mesh scaling study into checkable
evidence. If a change silently adds, removes, or inflates a collective,
these assertions name it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legion.parallel.feature_exchange import (
    owner_cap, shard_rows, sharded_row_fetch_psum, sharded_row_fetch_stats)
from legion.utils.comm import (
    exact_exchange_bytes, halo_exact_fetch_bytes, halo_exact_hop_bytes,
    hlo_collective_bytes, link_bytes, psum_exchange_bytes)

K, N, D, M = 4, 1000, 16, 96


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:K]).reshape(K), ("cache",))


def _compiled(mesh, fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _striped_args(mesh):
    table = np.zeros((N, D), np.float32)
    rows = jax.device_put(shard_rows(table, K).reshape(-1, D),
                          NamedSharding(mesh, P("cache")))
    ids = jax.device_put(jnp.zeros(K * M, jnp.int32),
                         NamedSharding(mesh, P("cache")))
    return rows, ids


def test_exact_exchange_hlo_matches_formula(mesh):
    rows, ids = _striped_args(mesh)

    def ex(rl, il):
        o, ov = sharded_row_fetch_stats(rl, il, "cache")
        return o, ov[None]

    txt = _compiled(mesh, jax.shard_map(
        ex, mesh=mesh, in_specs=(P("cache"), P("cache")),
        out_specs=(P("cache"), P("cache"))), rows, ids)
    got = hlo_collective_bytes(txt)
    want = exact_exchange_bytes(M, K, D, itemsize=4)
    assert got == want, (got, want)
    # the exact path must NOT smuggle in gathers/reduce-scatters
    assert "all-gather" not in got and "reduce-scatter" not in got


def test_exact_exchange_probed_cap_flows_to_hlo(mesh):
    """A PROBED (non-default) owner cap must flow through routing,
    demotion AND the compiled collective bytes — the closed form carries
    the cap."""
    rows, ids = _striped_args(mesh)
    cap = 40                        # != owner_cap(M, K) = 48

    def ex(rl, il):
        o, ov = sharded_row_fetch_stats(rl, il, "cache", cap=cap)
        return o, ov[None]

    txt = _compiled(mesh, jax.shard_map(
        ex, mesh=mesh, in_specs=(P("cache"), P("cache")),
        out_specs=(P("cache"), P("cache"))), rows, ids)
    got = hlo_collective_bytes(txt)
    want = exact_exchange_bytes(M, K, D, itemsize=4, cap=cap)
    assert got == want, (got, want)
    assert want["all-to-all"] < exact_exchange_bytes(
        M, K, D, itemsize=4)["all-to-all"]


def test_psum_exchange_hlo_matches_formula(mesh):
    rows, ids = _striped_args(mesh)
    txt = _compiled(mesh, jax.shard_map(
        lambda rl, il: sharded_row_fetch_psum(rl, il, "cache"),
        mesh=mesh, in_specs=(P("cache"), P("cache")),
        out_specs=P("cache")), rows, ids)
    got = hlo_collective_bytes(txt)
    want = psum_exchange_bytes(M, K, D, itemsize=4)
    assert got == want, (got, want)


def test_exact_exchange_cuts_link_volume_by_k_over_slack(mesh):
    """The headline of the round: exchange traffic drops from ~K x the
    requested rows to ~owner_cap_slack x (reference bar: P2P reads move
    exactly the requested bytes, src/Kernels.cu:695-699)."""
    exact = link_bytes(exact_exchange_bytes(M, K, D), K)
    psum = link_bytes(psum_exchange_bytes(M, K, D), K)
    cap = owner_cap(M, K)
    slack = cap * K / M
    assert exact < psum / (K / slack) * 1.1, (exact, psum)
    # and in absolute terms the response rows dominate: exact ~ slack*M*D
    assert exact <= slack * M * (D * 4 + 4) * 1.1


def test_striped_topo_sample_hot_hlo(mesh):
    """sample_hot's routed exchange: three all_to_alls (ids + draw-index
    payload + fanout-wide draws), no psum_scatter."""
    from legion.cache.striped import StripedTopoCache
    fanout = 5
    cap = owner_cap(M, K)
    hot = jax.device_put(jnp.arange(64, dtype=jnp.int32),
                         NamedSharding(mesh, P()))
    sp = jax.device_put(jnp.zeros((K, 17), jnp.int32),
                        NamedSharding(mesh, P("cache")))
    si = jax.device_put(jnp.zeros((K, 32), jnp.int32),
                        NamedSharding(mesh, P("cache")))
    key = jax.device_put(jax.random.PRNGKey(0), NamedSharding(mesh, P()))
    fr = jax.device_put(jnp.zeros(K * M, jnp.int32),
                        NamedSharding(mesh, P("cache")))

    def f(hot, sp, si, key, fr):
        nbr, hit = StripedTopoCache.sample_hot(hot, sp, si, key, fr,
                                               fanout)
        return nbr, hit

    txt = _compiled(mesh, jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(), P("cache"), P("cache"), P(), P("cache")),
        out_specs=(P("cache"), P("cache"))), hot, sp, si, key, fr)
    got = hlo_collective_bytes(txt)
    want = {"all-to-all": K * cap * 4 * 2 + K * cap * fanout * 4}
    assert got == want, (got, want)


def _dp_fixture(small_graph):
    from legion.config import (Config, DatasetConfig, ModelConfig,
                               SamplerConfig, TrainConfig)
    from legion.models import build_model
    from legion.parallel.dp import make_dp_train_step
    from legion.parallel.mesh import make_mesh
    from legion.sampling.block import frontier_caps
    from legion.sampling.sampler import (DeviceGraph, gather_features,
                                         sample_batch)
    from legion.train.train_state import create_train_state

    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0))
    mesh4 = make_mesh(4, cache_group_size=1)
    graph = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    caps = frontier_caps(32, (4, 3))
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)
    feats = jnp.asarray(np.asarray(small_graph.features))
    rng = np.random.default_rng(7)
    seeds = jnp.asarray(rng.permutation(
        np.asarray(small_graph.train_ids))[: 4 * 32].astype(np.int32))
    labels = jnp.asarray(np.asarray(small_graph.labels)[seeds])
    b = sample_batch(jax.random.PRNGKey(0), graph, seeds[:32],
                     jnp.full((), 32, jnp.int32), labels[:32], (4, 3),
                     caps)
    x = gather_features(feats, b.frontier)
    params = model.init(jax.random.PRNGKey(0),
                        tuple(reversed(b.blocks)), x,
                        deterministic=True)["params"]
    state = create_train_state(params, 0.01, 0)
    step, _ = make_dp_train_step(cfg, model, caps, mesh4)
    return cfg, mesh4, graph, caps, model, feats, seeds, labels, \
        params, state, step


def test_dp_grad_allreduce_bytes(small_graph):
    """The DP step's all-reduce volume is the parameter bytes ONCE (+
    small scalar psums) — the NCCL-DDP analog, now pinned. Guards
    against the double all-reduce of pmean-after-auto-psum (jax-0.9
    shard_map vma already sums grads at the pvary transpose)."""
    from legion.utils.comm import param_bytes
    (cfg, mesh4, graph, caps, model, feats, seeds, labels, params,
     state, step) = _dp_fixture(small_graph)
    txt = step.lower(state, graph, feats, seeds,
                     jnp.full((), 32, jnp.int32), labels).compile(
                     ).as_text()
    got = hlo_collective_bytes(txt)
    pb = param_bytes(params)
    assert "all-to-all" not in got and "reduce-scatter" not in got
    assert pb <= got.get("all-reduce", 0) <= pb + 256, (got, pb)


def test_striped_cached_step_collective_composition(small_graph):
    """The FULL striped-cached train step (Kg=2) contains exactly: the
    exact exchange's two all_to_alls at the closed-form bytes, one
    param-sized gradient all-reduce (+ scalar loss), and NOTHING else —
    and the sample+plan program contains NO collectives at all. A
    regression that reintroduces the psum exchange or a second gradient
    all-reduce fails here by name."""
    from legion.cache.feature_cache import FeatureCache
    from legion.cache.striped import StripedFeatureCache
    from legion.cache.striped_pipeline import StripedCachedTrainer
    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, SamplerConfig,
                               TrainConfig)
    from legion.models import build_model
    from legion.parallel.mesh import make_mesh
    from legion.sampling.block import frontier_caps
    from legion.sampling.sampler import DeviceGraph
    from legion.train.train_state import create_train_state
    from legion.utils.comm import param_bytes

    mesh2 = make_mesh(2, cache_group_size=2)
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes,
                              feature_placement="host"),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=32,
                              probe_caps=False),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0),
        cache=CacheConfig(enabled=True, budget_bytes=1 << 18,
                          group_size=2, presample_steps=2))
    caps = frontier_caps(32, (4, 3))
    graph = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    feats = np.asarray(small_graph.features)
    order = np.arange(feats.shape[0], dtype=np.int32)
    miss_cap = caps[-1]
    sc = StripedFeatureCache.build(feats, order, 700, miss_cap, mesh2)
    fc = FeatureCache.build(feats, order, 700, miss_cap=miss_cap)
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)
    tr = StripedCachedTrainer(cfg, model, caps, graph, sc, mesh2,
                              host_stage=fc.stage)

    n = 2
    rep = NamedSharding(mesh2, P())
    shard = NamedSharding(mesh2, P(("data", "cache")))
    key = jax.device_put(jax.random.PRNGKey(0), rep)
    seeds = jax.device_put(
        jnp.arange(n * 32, dtype=jnp.int32), shard)
    nb = jax.device_put(jnp.full((n,), 32, jnp.int32), shard)
    labels = jax.device_put(jnp.zeros((n * 32,), jnp.int32), shard)

    sp_txt = tr.jit_sample_plan.lower(
        key, tr.graph, sc.hot_ids, seeds, nb, labels).compile().as_text()
    assert hlo_collective_bytes(sp_txt) == {}, (
        "sample+plan must be collective-free (per-chip work only)")

    batch, plan, packed = tr.jit_sample_plan(
        key, tr.graph, sc.hot_ids, seeds, nb, labels)
    _, staged = tr._stage(np.asarray(packed).reshape(n, -1))

    # init a state on the mesh (shapes only)
    import jax.random as jr
    from legion.sampling.sampler import gather_features, sample_batch
    b0 = sample_batch(jr.PRNGKey(0), graph,
                      jnp.arange(32, dtype=jnp.int32),
                      jnp.full((), 32, jnp.int32),
                      jnp.zeros((32,), jnp.int32), (4, 3), caps,
                      dedup_last=True)
    x0 = gather_features(jnp.asarray(feats), b0.frontier)
    params = model.init(jr.PRNGKey(0), tuple(reversed(b0.blocks)), x0,
                        deterministic=True)["params"]
    state = jax.device_put(create_train_state(params, 0.01, 0), rep)

    txt = tr.jit_train_from.lower(state, sc.rows, batch, plan,
                                  staged).compile().as_text()
    got = hlo_collective_bytes(txt)
    m = caps[-1]
    d = sc.rows.shape[1]
    want_a2a = exact_exchange_bytes(
        m, 2, d, itemsize=sc.rows.dtype.itemsize)["all-to-all"]
    pb = param_bytes(params)
    assert got.get("all-to-all", 0) == want_a2a, (got, want_a2a)
    assert "all-gather" not in got and "reduce-scatter" not in got, got
    assert pb <= got.get("all-reduce", 0) <= pb + 64, (got, pb)

    # the striped-cached EVAL program: exchange + scalar psums only (no
    # gradient all-reduce) — completes the assertion matrix row
    txt = tr.jit_eval_from.lower(
        jax.device_put(params, rep), sc.rows, batch, plan,
        staged).compile().as_text()
    got = hlo_collective_bytes(txt)
    assert got.get("all-to-all", 0) == want_a2a, (got, want_a2a)
    assert "all-gather" not in got and "reduce-scatter" not in got, got
    assert got.get("all-reduce", 0) <= 64, got


def test_dp_grads_are_mean_of_shard_grads(small_graph):
    """DDP semantics pin: the mesh step's applied gradient must equal
    the MEAN over shards of the per-shard gradients (computed here
    shard by shard on one chip with the identical key schedule). Before
    round 4 the mesh trainers applied the SUM — the auto-psum of the
    vma transpose followed by pmean-of-identical-sums — silently
    scaling the effective lr by the device count."""
    from legion.sampling.sampler import gather_features, sample_batch
    from legion.train.loop import masked_softmax_ce
    from legion.train.train_state import create_train_state
    (cfg, mesh4, graph, caps, model, feats, seeds, labels, params,
     state, step) = _dp_fixture(small_graph)
    # the jitted step donates its state buffers — keep an owned copy
    params = jax.tree_util.tree_map(jnp.copy, params)

    state2, metrics = step(state, graph, feats, seeds,
                           jnp.full((), 32, jnp.int32), labels)

    # reference: replay each shard's exact sampling/dropout keys
    st = create_train_state(params, cfg.train.learning_rate,
                            cfg.train.seed)
    base = jax.random.fold_in(st.rng, st.step)
    acc = None
    for c in range(4):
        key = jax.random.fold_in(base, jnp.int32(c))
        skey, dkey = jax.random.split(key)
        bc = sample_batch(skey, graph, seeds[c * 32:(c + 1) * 32],
                          jnp.full((), 32, jnp.int32),
                          labels[c * 32:(c + 1) * 32],
                          tuple(cfg.sampler.fanouts), caps,
                          dedup_last=cfg.sampler.dedup_last)

        def lf(p):
            x = gather_features(feats, bc.frontier, mask_invalid=False)
            out = model.apply({"params": p},
                              tuple(reversed(bc.blocks)), x,
                              deterministic=False,
                              rngs={"dropout": dkey})
            out = out[: bc.seed_cap]
            return masked_softmax_ce(out, bc.labels, bc.seed_mask())

        g = jax.grad(lf)(params)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    gmean = jax.tree.map(lambda a: a / 4.0, acc)
    want = st.apply_gradients(gmean)
    for a, b in zip(jax.tree_util.tree_leaves(state2.params),
                    jax.tree_util.tree_leaves(want.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# Round-5 additions: the exact halo exchange and the
# remaining step programs — striped-hybrid train/eval, the partitioned
# step, and the DP/striped eval programs. Every driver's compiled
# collective composition is now either asserted exactly or pinned
# collective-free (the full matrix lives in docs/ARCHITECTURE.md).
# ---------------------------------------------------------------------------


def _halo_shard_args(small_graph, k):
    from legion.data.partition import partition_graph
    from legion.parallel.halo import HostShard
    part = partition_graph(small_graph, k, mode="hash")
    parts = HostShard.build(small_graph.indptr, small_graph.indices,
                            small_graph.features, part, k)
    return part, [np.stack([p[i] for p in parts]) for i in range(4)]


def test_halo_exact_fetch_hlo_matches_formula(mesh, small_graph):
    from legion.parallel.halo import (HostShard,
                                      partitioned_row_fetch_exact)
    part, stacked = _halo_shard_args(small_graph, K)
    sh = NamedSharding(mesh, P("cache"))
    owned, sp, si, fr = [jax.device_put(jnp.asarray(a), sh)
                         for a in stacked]
    owner_t = jax.device_put(jnp.asarray(part.astype(np.int8)),
                             NamedSharding(mesh, P()))
    ids = jax.device_put(jnp.zeros(K * M, jnp.int32), sh)
    dcaps = (48, 40, 32)  # deliberately non-uniform

    def f(owned, sp, si, fr, owner_t, ids):
        shard = HostShard(owned_ids=owned[0], sub_indptr=sp[0],
                          sub_indices=si[0], feat_rows=fr[0])
        rows, ov = partitioned_row_fetch_exact(shard, owner_t, ids,
                                               "cache", dcaps)
        return rows, ov[None]

    txt = _compiled(mesh, jax.shard_map(
        f, mesh=mesh, in_specs=(P("cache"),) * 4 + (P(), P("cache")),
        out_specs=(P("cache"), P("cache"))), owned, sp, si, fr,
        owner_t, ids)
    got = hlo_collective_bytes(txt)
    want = halo_exact_fetch_bytes(dcaps, small_graph.features.shape[1])
    assert got == want, (got, want)
    assert "all-gather" not in got and "reduce-scatter" not in got


def test_halo_exact_hop_hlo_matches_formula(mesh, small_graph):
    from legion.parallel.halo import (HostShard,
                                      partitioned_sample_hop_exact)
    part, stacked = _halo_shard_args(small_graph, K)
    sh = NamedSharding(mesh, P("cache"))
    owned, sp, si, fr = [jax.device_put(jnp.asarray(a), sh)
                         for a in stacked]
    owner_t = jax.device_put(jnp.asarray(part.astype(np.int8)),
                             NamedSharding(mesh, P()))
    frontier = jax.device_put(jnp.zeros(K * M, jnp.int32), sh)
    key = jax.device_put(jax.random.PRNGKey(0), NamedSharding(mesh, P()))
    dcaps, fanout = (40, 24, 16), 5

    def f(owned, sp, si, fr, owner_t, key, frontier):
        shard = HostShard(owned_ids=owned[0], sub_indptr=sp[0],
                          sub_indices=si[0], feat_rows=fr[0])
        nbr, ov = partitioned_sample_hop_exact(
            shard, owner_t, key, frontier, fanout, "cache", dcaps)
        return nbr, ov[None]

    txt = _compiled(mesh, jax.shard_map(
        f, mesh=mesh,
        in_specs=(P("cache"),) * 4 + (P(), P(), P("cache")),
        out_specs=(P("cache"), P("cache"))), owned, sp, si, fr,
        owner_t, key, frontier)
    got = hlo_collective_bytes(txt)
    want = halo_exact_hop_bytes(dcaps, fanout)
    assert got == want, (got, want)
    assert "all-gather" not in got and "reduce-scatter" not in got


def test_partitioned_step_collective_composition(small_graph):
    """The FULL exact-halo partitioned train step contains exactly: the
    per-distance ppermutes of its 2 sampling hops + feature fetch at
    the closed-form bytes, one param-sized gradient all-reduce (+
    scalar loss/edges/overflow reductions), and NO gather/scatter
    collectives (the psum path's signature). VERDICT r4 #2 'done when'
    criterion."""
    from jax.sharding import Mesh
    from legion.config import (Config, DatasetConfig, ModelConfig,
                               SamplerConfig, TrainConfig)
    from legion.models import build_model
    from legion.parallel.multihost import make_partitioned_train_step
    from legion.sampling.block import frontier_caps
    from legion.sampling.sampler import DeviceGraph, sample_batch
    from legion.train.train_state import create_train_state
    from legion.utils.comm import param_bytes

    k, b, fanouts = 4, 32, (4, 3)
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes),
        sampler=SamplerConfig(fanouts=fanouts, batch_size=b),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0))
    caps = frontier_caps(b, fanouts)
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)
    pmesh = Mesh(np.array(jax.devices()[:k]), ("data",))
    dcaps = (96, 64, 48)
    pstep, put_shards = make_partitioned_train_step(
        cfg, model, caps, pmesh, dist_caps=dcaps)
    from legion.data.partition import partition_graph
    part = partition_graph(small_graph, k, mode="greedy")
    shard_args = put_shards(small_graph.indptr, small_graph.indices,
                            small_graph.features, part)

    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    b0 = sample_batch(jax.random.PRNGKey(0), g,
                      jnp.arange(b, dtype=jnp.int32),
                      jnp.full((), b, jnp.int32),
                      jnp.zeros((b,), jnp.int32), fanouts, caps)
    x0 = jnp.zeros((caps[-1], small_graph.feature_dim), jnp.float32)
    params = model.init(jax.random.PRNGKey(0),
                        tuple(reversed(b0.blocks)), x0,
                        deterministic=True)["params"]
    state = create_train_state(params, 0.01, 0)
    psh = NamedSharding(pmesh, P("data"))
    seeds = jax.device_put(jnp.zeros(k * b, jnp.int32), psh)
    nb = jax.device_put(jnp.full((k,), b, jnp.int32), psh)
    labels = jax.device_put(jnp.zeros(k * b, jnp.int32), psh)

    txt = pstep.lower(state, *shard_args, seeds, nb,
                      labels).compile().as_text()
    got = hlo_collective_bytes(txt)
    d = small_graph.features.shape[1]
    want_cp = (sum(halo_exact_hop_bytes(dcaps, f)["collective-permute"]
                   for f in fanouts)
               + halo_exact_fetch_bytes(dcaps, d)["collective-permute"])
    pb = param_bytes(params)
    assert got.get("collective-permute", 0) == want_cp, (got, want_cp)
    assert "all-gather" not in got and "reduce-scatter" not in got, got
    assert "all-to-all" not in got, got
    assert pb <= got.get("all-reduce", 0) <= pb + 256, (got, pb)


def test_striped_hybrid_collective_composition(small_graph):
    """The striped-hybrid programs (the uk-scale multi-chip flagship,
    VERDICT r4 weak #3): every hop program carries exactly ONE
    sample_hot exchange (3 all_to_alls at its hop's owner cap — j_finish
    carries the NEXT batch's hop-0 too), the train step carries the
    exact feature exchange + ONE param-sized all-reduce, eval the
    exchange + scalar psums — and nothing else."""
    from tests.test_striped_hybrid import BATCH, FANOUTS, _mk_striped
    from legion.parallel.feature_exchange import owner_cap
    from legion.parallel.mesh import make_mesh
    from legion.train.train_state import create_train_state
    from legion.utils.comm import param_bytes

    mesh2 = make_mesh(4, cache_group_size=2)
    kg = 2
    (cfg, caps, indptr, indices, feats, topo_order, feat_order, fc,
     model, params, tr) = _mk_striped(small_graph, mesh2)

    def a2a_hot(m, fanout, cap):
        return exact_exchange_bytes(m, kg, fanout, itemsize=4, cap=cap,
                                    payload=True)["all-to-all"]

    n = 4
    rep = NamedSharding(mesh2, P())
    shard = NamedSharding(mesh2, P(("data", "cache")))
    key = jax.device_put(jax.random.PRNGKey(0), rep)
    seeds = jax.device_put(jnp.zeros((n, BATCH), jnp.int32), shard)
    nb = jax.device_put(jnp.full((n,), BATCH, jnp.int32), shard)

    tcaps = [c if c is not None else owner_cap(caps[k], kg)
             for k, c in enumerate(tr.topo_owner_caps)]

    # hop programs
    txt = tr._j_start.lower(tr.topo.hot_ids, tr.topo.sub_indptr,
                            tr.topo.sub_indices, key, seeds,
                            nb).compile().as_text()
    got = hlo_collective_bytes(txt)
    assert got == {"all-to-all": a2a_hot(caps[0], FANOUTS[0], tcaps[0])}, got

    carry, packed = tr._j_start(tr.topo.hot_ids, tr.topo.sub_indptr,
                                tr.topo.sub_indices, key, seeds, nb)
    cold = jax.device_put(
        jnp.zeros((n, caps[0], FANOUTS[0]), jnp.int32), shard)
    txt = tr._j_steps[0].lower(
        tr.topo.hot_ids, tr.topo.sub_indptr, tr.topo.sub_indices, key,
        *carry, cold).compile().as_text()
    got = hlo_collective_bytes(txt)
    assert got == {"all-to-all": a2a_hot(caps[1], FANOUTS[1], tcaps[1])}, got

    st = tr._j_steps[0](tr.topo.hot_ids, tr.topo.sub_indptr,
                        tr.topo.sub_indices, key, *carry, cold)
    frontier, num, _blk, nbrs_hot, hit = st[0], st[1], st[2], st[3], st[4]
    cold2 = jax.device_put(
        jnp.zeros((n, caps[1], FANOUTS[1]), jnp.int32), shard)
    txt = tr._j_finish.lower(
        tr.topo.hot_ids, tr.topo.sub_indptr, tr.topo.sub_indices,
        tr.fcache.hot_ids, key, seeds, nb, frontier, num, nbrs_hot, hit,
        cold2).compile().as_text()
    got = hlo_collective_bytes(txt)
    # j_finish: next batch's hop-0 exchange ONLY (feature planning and
    # demotion are collective-free — routing is local)
    assert got == {"all-to-all": a2a_hot(caps[0], FANOUTS[0], tcaps[0])}, got

    # train/eval: exact feature exchange + grad all-reduce / psums
    fin = tr._j_finish(tr.topo.hot_ids, tr.topo.sub_indptr,
                       tr.topo.sub_indices, tr.fcache.hot_ids, key,
                       seeds, nb, frontier, num, nbrs_hot, hit, cold2)
    frontier2, num2, blk2, plan = fin[0], fin[1], fin[2], fin[3]
    batch = tr._batch([_blk, blk2], frontier2, num2,
                      np.zeros(n * BATCH, np.int32),
                      np.zeros(n * BATCH, np.int32), nb)
    staged = jax.device_put(
        jnp.zeros((n, tr.fcache.miss_cap, feats.shape[1]), jnp.float32),
        shard)
    state = jax.device_put(create_train_state(params, 0.01, 0), rep)
    txt = tr.jit_train_from.lower(state, tr.fcache.rows, batch, plan,
                                  staged).compile().as_text()
    got = hlo_collective_bytes(txt)
    ocap = tr.fcache.owner_cap_rows or owner_cap(caps[-1], kg)
    want_a2a = exact_exchange_bytes(
        caps[-1], kg, feats.shape[1], itemsize=4,
        cap=ocap)["all-to-all"]
    pb = param_bytes(params)
    assert got.get("all-to-all", 0) == want_a2a, (got, want_a2a)
    assert "all-gather" not in got and "reduce-scatter" not in got, got
    assert pb <= got.get("all-reduce", 0) <= pb + 64, (got, pb)

    txt = tr.jit_eval_from.lower(
        jax.device_put(params, rep), tr.fcache.rows, batch, plan,
        staged).compile().as_text()
    got = hlo_collective_bytes(txt)
    assert got.get("all-to-all", 0) == want_a2a, (got, want_a2a)
    assert "all-gather" not in got and "reduce-scatter" not in got, got
    assert got.get("all-reduce", 0) <= 64, got  # scalar psums only


def test_eval_programs_collective_composition(small_graph):
    """Eval programs: the DP eval scan is
    scalar-reductions-only; the striped eval step is the exact exchange
    + scalar psums (no gradient all-reduce, no gathers)."""
    from legion.train.loop import make_step_fns
    (cfg, mesh4, graph, caps, model, feats, seeds, labels, params,
     state, step) = _dp_fixture(small_graph)
    # DP eval via the shard_axes step fns directly (the dp driver path)
    fns = make_step_fns(cfg, model, caps, shard_axes=("data", "cache"))
    import functools
    ev = jax.jit(jax.shard_map(
        functools.partial(fns.eval_step),
        mesh=mesh4,
        in_specs=(P(), P(), P(), P(("data", "cache")), P(),
                  P(("data", "cache")), P()),
        out_specs=(P(), P())))
    key = jax.device_put(jax.random.PRNGKey(0),
                         NamedSharding(mesh4, P()))
    sh = NamedSharding(mesh4, P(("data", "cache")))
    s4 = jax.device_put(jnp.zeros(4 * 32, jnp.int32), sh)
    l4 = jax.device_put(jnp.zeros(4 * 32, jnp.int32), sh)
    txt = ev.lower(params, graph, feats, s4,
                   jnp.full((), 32, jnp.int32), l4,
                   key).compile().as_text()
    got = hlo_collective_bytes(txt)
    assert "all-to-all" not in got and "all-gather" not in got, got
    assert "reduce-scatter" not in got, got
    assert got.get("all-reduce", 0) <= 64, got  # scalar psums only
