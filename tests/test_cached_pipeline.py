"""CachedTrainer end-to-end: trains with host-resident features, reports
hit rate, and matches the all-HBM trainer's loss trajectory when the
cache holds everything."""

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.feature_cache import FeatureCache
from legion.cache.pipeline import CachedTrainer
from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
from legion.models import build_model
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph
from legion.train.train_state import create_train_state


def _mk(small_graph, capacity, batch=64):
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes,
                              feature_placement="host"),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=batch),
        model=ModelConfig(arch="sage", hidden_dim=16, num_layers=2,
                          dropout=0.0),
        train=TrainConfig(learning_rate=0.01, seed=0, pipeline_depth=2),
    )
    caps = frontier_caps(batch, cfg.sampler.fanouts)
    graph = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    feats = np.asarray(small_graph.features)
    order = np.arange(feats.shape[0], dtype=np.int32)  # id order "hotness"
    cache = FeatureCache.build(feats, order, capacity=capacity,
                               miss_cap=caps[-1])
    model = build_model("sage", 16, small_graph.num_classes, 2, 0.0)
    return cfg, caps, graph, cache, model, feats


def _params(model, graph, caps, cfg, feats):
    from legion.sampling.sampler import gather_features, sample_batch
    b = cfg.sampler.batch_size
    batch = sample_batch(jax.random.PRNGKey(0), graph,
                         jnp.arange(b, dtype=jnp.int32),
                         jnp.full((), b, jnp.int32),
                         jnp.zeros((b,), jnp.int32),
                         tuple(cfg.sampler.fanouts), caps)
    x = gather_features(jnp.asarray(feats), batch.frontier)
    return model.init(jax.random.PRNGKey(0), tuple(reversed(batch.blocks)),
                      x, deterministic=True)["params"]


def test_cached_trainer_learns_partial_cache(small_graph):
    cfg, caps, graph, cache, model, feats = _mk(small_graph, capacity=700)
    params = _params(model, graph, caps, cfg, feats)
    state = create_train_state(params, 0.01, 0)
    tr = CachedTrainer(cfg, model, caps, graph, cache)

    ids = np.asarray(small_graph.train_ids)
    steps, b = 8, cfg.sampler.batch_size
    seeds = np.stack([ids[i * b:(i + 1) * b] for i in range(steps)]).astype(np.int32)
    labels = np.asarray(small_graph.labels)[seeds]
    r1 = tr.run_epoch(state, seeds, labels)
    assert 0.0 < r1["cache_hit_rate"] < 1.0
    assert np.isfinite(r1["loss"])
    assert r1["host_gb"] > 0
    r2 = tr.run_epoch(r1["state"], seeds, labels)
    assert r2["loss"] < r1["loss"] * 1.5  # trending down-ish on reruns


def test_cached_matches_uncached_when_cache_holds_all(small_graph):
    """Full-capacity cache: identical numerics to the plain HBM path."""
    from legion.train.loop import make_step_fns
    cfg, caps, graph, cache, model, feats = _mk(
        small_graph, capacity=small_graph.num_nodes)
    params = _params(model, graph, caps, cfg, feats)

    ids = np.asarray(small_graph.train_ids)
    b = cfg.sampler.batch_size
    seeds = ids[:2 * b].reshape(2, b).astype(np.int32)
    labels = np.asarray(small_graph.labels)[seeds]

    # cached run
    st1 = create_train_state(jax.tree_util.tree_map(jnp.copy, params), 0.01, 0)
    tr = CachedTrainer(cfg, model, caps, graph, cache)
    r = tr.run_epoch(st1, seeds, labels)
    assert r["cache_hit_rate"] == 1.0

    # plain run, same seeds/keys
    train_step = make_step_fns(cfg, model, caps).train_step
    st2 = create_train_state(jax.tree_util.tree_map(jnp.copy, params), 0.01, 0)
    # reproduce CachedTrainer's key schedule
    key = jax.random.fold_in(st2.rng, 0)
    from legion.sampling.sampler import gather_features, sample_batch
    feats_dev = jnp.asarray(feats)
    for i in range(2):
        k = jax.random.fold_in(key, i)
        batch = sample_batch(k, graph, jnp.asarray(seeds[i]),
                             jnp.full((), b, jnp.int32),
                             jnp.asarray(labels[i]),
                             tuple(cfg.sampler.fanouts), caps)
        x = gather_features(feats_dev, batch.frontier)
        # manual train step mirroring CachedTrainer.train_from
        from legion.train.loop import masked_softmax_ce

        def loss_fn(p, dkey):
            out = model.apply({"params": p}, tuple(reversed(batch.blocks)),
                              x, deterministic=False,
                              rngs={"dropout": dkey})
            return masked_softmax_ce(out[: batch.seed_cap], batch.labels,
                                     batch.seed_mask())
        kk = jax.random.fold_in(st2.rng, st2.step)
        _, dkey = jax.random.split(kk)
        loss, grads = jax.value_and_grad(loss_fn)(st2.params, dkey)
        st2 = st2.apply_gradients(grads)

    for a, c in zip(jax.tree_util.tree_leaves(r["state"].params),
                    jax.tree_util.tree_leaves(st2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=2e-4, atol=1e-5)


def test_cached_training_bf16_cache(small_graph):
    """bf16 model => bf16 cache rows + staging: runs end-to-end through
    run_cached_training, hit rate sane, loss finite, staged dtype bf16."""
    import ml_dtypes
    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, SamplerConfig, TrainConfig)
    from legion.train.cached_driver import run_cached_training
    cfg = Config(
        dataset=DatasetConfig(num_classes=small_graph.num_classes,
                              feature_placement="host"),
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=64,
                              dedup_last=True, probe_caps=False),
        model=ModelConfig(arch="sage", hidden_dim=32, num_layers=2,
                          dropout=0.0, dtype="bfloat16"),
        train=TrainConfig(epochs=1, learning_rate=0.01),
        cache=CacheConfig(enabled=True, budget_bytes=64 * 1024),
    )
    res = run_cached_training(cfg, small_graph, log=lambda s: None)
    h = res["history"][-1]
    assert np.isfinite(h["loss"])
    assert 0.0 < h["cache_hit_rate"] <= 1.0
    assert h["host_gb"] > 0.0


def test_cached_eval_pipelined(small_graph):
    """CachedTrainer eval dispatches sample+plan depth steps ahead and
    accumulates metrics on device (one fetch per epoch, not 2/step)."""
    cfg, caps, graph, cache, model, feats = _mk(small_graph, capacity=700)
    params = _params(model, graph, caps, cfg, feats)
    tr = CachedTrainer(cfg, model, caps, graph, cache)

    ids = np.asarray(small_graph.valid_ids)
    steps, b = 4, cfg.sampler.batch_size
    seeds = np.full((steps, b), -1, np.int32)
    counts = np.zeros((steps,), np.int32)
    for t in range(steps):
        chunk = ids[t * 32:(t + 1) * 32]
        seeds[t, : len(chunk)] = chunk
        counts[t] = len(chunk)
    labels = np.where(seeds >= 0,
                      np.asarray(small_graph.labels)[np.clip(seeds, 0, None)],
                      -1).astype(np.int32)

    events = []
    orig_plan, orig_stage = tr.jit_sample_plan, tr.host_stage
    tr.jit_sample_plan = lambda *a: (events.append("d"), orig_plan(*a))[1]
    tr.host_stage = lambda p: (events.append("s"), orig_stage(p))[1]
    acc = tr.eval_epoch(params, seeds, counts, labels)
    assert 0.0 <= acc <= 1.0
    assert events[:3] == ["d", "d", "s"], events
    assert events.count("d") == steps and events.count("s") == steps
