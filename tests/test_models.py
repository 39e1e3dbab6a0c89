"""Per-layer activation parity vs numpy oracles + shape/mask checks."""

import jax
import jax.numpy as jnp
import numpy as np

from legion.models.gcn import graph_conv, graph_conv_init
from legion.models.sage import SAGE, sage_conv, sage_conv_init
from legion.sampling.block import frontier_caps
from legion.sampling.sampler import DeviceGraph, gather_features, sample_batch
from tests.oracle import decode_block, gcn_conv_np, sage_conv_np


def _batch(small_graph, b=32, fanouts=(5, 3), key=0):
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    seeds_np = np.unique(np.asarray(small_graph.train_ids)[:b]).astype(np.int32)
    seeds = np.full((b,), -1, np.int32)
    seeds[:seeds_np.shape[0]] = seeds_np
    return sample_batch(jax.random.PRNGKey(key), g, jnp.asarray(seeds),
                        jnp.full((), seeds_np.shape[0], jnp.int32),
                        jnp.zeros((b,), jnp.int32), fanouts,
                        frontier_caps(b, fanouts))


def test_sageconv_matches_oracle(small_graph):
    batch = _batch(small_graph)
    blk = batch.blocks[-1]  # innermost hop: dst = hop-1 frontier
    # the last block's src level IS the final frontier, so raw features
    # over the frontier are valid src activations
    h_src = np.asarray(gather_features(
        jnp.asarray(np.asarray(small_graph.features)), batch.frontier))

    p = sage_conv_init(jax.random.PRNGKey(0), h_src.shape[1], 16)
    out = np.asarray(sage_conv(p, blk, jnp.asarray(h_src)))

    edges, num_src, num_dst = decode_block(batch, blk)
    ref = sage_conv_np(h_src, edges, blk.dst_cap,
                       np.asarray(p["fc_self"]["kernel"]),
                       np.asarray(p["fc_self"]["bias"]),
                       np.asarray(p["fc_neigh"]["kernel"]))
    np.testing.assert_allclose(out[:num_dst], ref[:num_dst],
                               rtol=1e-4, atol=1e-4)


def test_gcnconv_matches_oracle(small_graph):
    batch = _batch(small_graph, key=3)
    blk = batch.blocks[-1]
    h_src = np.asarray(gather_features(
        jnp.asarray(np.asarray(small_graph.features)), batch.frontier))
    p = graph_conv_init(jax.random.PRNGKey(1), h_src.shape[1], 16)
    out = np.asarray(graph_conv(p, blk, jnp.asarray(h_src)))
    edges, num_src, num_dst = decode_block(batch, blk)
    ref = gcn_conv_np(h_src, edges, h_src.shape[0], blk.dst_cap,
                      np.asarray(p["dense"]["kernel"]),
                      np.asarray(p["bias"]))
    np.testing.assert_allclose(out[:num_dst], ref[:num_dst],
                               rtol=1e-4, atol=1e-4)


def test_sage_full_forward_shapes(small_graph):
    batch = _batch(small_graph, fanouts=(4, 4))
    x = gather_features(jnp.asarray(np.asarray(small_graph.features)),
                        batch.frontier)
    model = SAGE(hidden_dim=32, out_dim=7, num_layers=2, dropout=0.5)
    blocks = tuple(reversed(batch.blocks))
    params = model.init(jax.random.PRNGKey(0), blocks, x, deterministic=True)
    out = model.apply(params, blocks, x, deterministic=True)
    assert out.shape == (batch.seed_cap, 7)
    assert np.isfinite(np.asarray(out)).all()

    # dropout path runs and differs
    out2 = model.apply(params, blocks, x, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(2)})
    assert (np.asarray(out2) != np.asarray(out)).any()


def _batch_nodedup(small_graph, b=32, fanouts=(5, 3), key=0):
    g = DeviceGraph.from_host(small_graph.indptr, small_graph.indices)
    seeds_np = np.unique(np.asarray(small_graph.train_ids)[:b]).astype(np.int32)
    seeds = np.full((b,), -1, np.int32)
    seeds[:seeds_np.shape[0]] = seeds_np
    return sample_batch(jax.random.PRNGKey(key), g, jnp.asarray(seeds),
                        jnp.full((), seeds_np.shape[0], jnp.int32),
                        jnp.zeros((b,), jnp.int32), fanouts,
                        frontier_caps(b, fanouts), dedup_last=False)


def test_sageconv_identity_block_matches_oracle(small_graph):
    """Identity-layout (no-dedup) block through the reshape fast path
    must match the edge-decoded numpy oracle."""
    batch = _batch_nodedup(small_graph)
    blk = batch.blocks[-1]
    assert blk.identity_offset is not None
    h_src = np.asarray(gather_features(
        jnp.asarray(np.asarray(small_graph.features)), batch.frontier))
    p = sage_conv_init(jax.random.PRNGKey(0), h_src.shape[1], 16)
    out = np.asarray(sage_conv(p, blk, jnp.asarray(h_src)))
    edges, _, num_dst = decode_block(batch, blk)
    ref = sage_conv_np(h_src, edges, blk.dst_cap,
                       np.asarray(p["fc_self"]["kernel"]),
                       np.asarray(p["fc_self"]["bias"]),
                       np.asarray(p["fc_neigh"]["kernel"]))
    np.testing.assert_allclose(out[:num_dst], ref[:num_dst],
                               rtol=1e-4, atol=1e-4)


def test_gcnconv_identity_block_matches_oracle(small_graph):
    batch = _batch_nodedup(small_graph, key=3)
    blk = batch.blocks[-1]
    h_src = np.asarray(gather_features(
        jnp.asarray(np.asarray(small_graph.features)), batch.frontier))
    p = graph_conv_init(jax.random.PRNGKey(1), h_src.shape[1], 16)
    out = np.asarray(graph_conv(p, blk, jnp.asarray(h_src)))
    edges, _, num_dst = decode_block(batch, blk)
    ref = gcn_conv_np(h_src, edges, h_src.shape[0], blk.dst_cap,
                      np.asarray(p["dense"]["kernel"]),
                      np.asarray(p["bias"]))
    np.testing.assert_allclose(out[:num_dst], ref[:num_dst],
                               rtol=1e-4, atol=1e-4)


def test_sage_forward_dedup_vs_append_equal(small_graph):
    """Full 2-layer forward: identical outputs (up to float assoc) with
    and without last-hop dedup under the same sampling key."""
    bd = _batch(small_graph, fanouts=(4, 4), key=9)
    ba = _batch_nodedup(small_graph, fanouts=(4, 4), key=9)
    feats = jnp.asarray(np.asarray(small_graph.features))
    model = SAGE(hidden_dim=32, out_dim=7, num_layers=2, dropout=0.0)
    xd = gather_features(feats, bd.frontier)
    xa = gather_features(feats, ba.frontier)
    params = model.init(jax.random.PRNGKey(0), tuple(reversed(bd.blocks)),
                        xd, deterministic=True)
    outd = np.asarray(model.apply(params, tuple(reversed(bd.blocks)), xd,
                                  deterministic=True))
    outa = np.asarray(model.apply(params, tuple(reversed(ba.blocks)), xa,
                                  deterministic=True))
    n = int(bd.num_seeds)
    np.testing.assert_allclose(outa[:n], outd[:n], rtol=1e-4, atol=1e-5)
