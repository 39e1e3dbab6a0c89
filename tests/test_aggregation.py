"""Masked fanout aggregation (ops.segment) against a float64 numpy oracle:
identity blocks (the last, un-deduped hop: a contiguous slice) and
gathered blocks (random positions), mean / sum / GCN sqrt norm, f32 and
bf16, zero-in-degree rows and an unpadded feature width; plus the
gradient rule of the gathered aggregation and the block SDDMM."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legion.models.gcn import graph_conv
from legion.ops.segment import fanout_gather_mean, fanout_gather_sum
from legion.sampling.block import Block

# f32 sums of <= 25 terms stay far inside 1e-5 of the float64 oracle;
# bf16 inputs carry 2^-8 relative rounding
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _oracle(rows, mask, norm):
    s = (rows.astype(np.float64) * mask[..., None]).sum(1)
    cnt = np.maximum(mask.sum(1), 1)[:, None].astype(np.float64)
    return {"mean": s / cnt, "sum": s, "sqrt": s / np.sqrt(cnt)}[norm]


def _identity_case(p, f, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    off = 3 * f + 5                       # prefix rows the block skips
    x = rng.standard_normal((off + p * f, d)).astype(np.float32)
    mask = rng.random((p, f)) < 0.7
    mask[::7] = False                     # zero-in-degree dst rows
    blk = Block(nbr_pos=jnp.zeros((p, f), jnp.int32),
                nbr_mask=jnp.asarray(mask), num_src=jnp.int32(off + p * f),
                num_dst=jnp.int32(p), identity_offset=off)
    xd = jnp.asarray(x, dtype)
    rows = np.asarray(xd.astype(jnp.float32))[off:].reshape(p, f, d)
    return xd, blk, rows, mask


def _agg(norm, h, blk):
    if norm == "mean":
        return fanout_gather_mean(h, blk)
    if norm == "sum":
        return fanout_gather_sum(h, blk)
    # GCN 'both' norm on an identity block, through the layer itself
    # with an identity kernel: sum / sqrt(in-degree)
    d = h.shape[1]
    p = {"dense": {"kernel": jnp.eye(d, dtype=jnp.float32)},
         "bias": jnp.zeros((d,), jnp.float32)}
    with jax.default_matmul_precision("highest"):
        return graph_conv(p, blk, h, h.dtype)


@pytest.mark.parametrize("d", [128, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["mean", "sum", "sqrt"])
def test_identity_aggregation_matches_oracle(norm, dtype, d):
    xd, blk, rows, mask = _identity_case(61, 10, d, dtype)
    got = jax.jit(_agg, static_argnums=0)(norm, xd, blk)
    want = _oracle(rows, mask, norm)
    assert got.shape == (61, d)
    assert _rel_err(got, want) <= TOL[dtype]
    assert np.all(np.asarray(got, np.float32)[::7] == 0.0)


@pytest.mark.parametrize("d", [128, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["mean", "sum"])
def test_gathered_aggregation_matches_oracle(norm, dtype, d):
    rng = np.random.default_rng(1)
    p, f, s = 37, 25, 300
    h = jnp.asarray(rng.standard_normal((s, d)).astype(np.float32), dtype)
    pos = rng.integers(0, s, (p, f)).astype(np.int32)
    mask = rng.random((p, f)) < 0.8
    mask[5] = False
    blk = Block(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(mask),
                num_src=jnp.int32(s), num_dst=jnp.int32(p))
    got = jax.jit(_agg, static_argnums=0)(norm, h, blk)
    want = _oracle(np.asarray(h.astype(jnp.float32))[pos], mask, norm)
    assert _rel_err(got, want) <= TOL[dtype]
    assert np.all(np.asarray(got, np.float32)[5] == 0.0)


@pytest.mark.parametrize("norm", ["mean", "sum"])
def test_gathered_aggregation_gradient(norm):
    """d/dh sum(agg(h) * w): every valid slot (d, j) adds w[d] (/ cnt[d]
    for mean) to row nbr_pos[d, j] — a row repeat scattered back by the
    gather's transpose."""
    rng = np.random.default_rng(2)
    p, f, s, d = 40, 7, 90, 16
    h = rng.standard_normal((s, d)).astype(np.float32)
    pos = rng.integers(0, s, (p, f)).astype(np.int32)
    mask = rng.random((p, f)) < 0.6
    mask[3] = False
    w = rng.standard_normal((p, d)).astype(np.float32)
    blk = Block(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(mask),
                num_src=jnp.int32(s), num_dst=jnp.int32(p))
    g = jax.grad(lambda x: jnp.sum(_agg(norm, x, blk) * w))(jnp.asarray(h))
    scale = w.astype(np.float64)
    if norm == "mean":
        scale = scale / np.maximum(mask.sum(1), 1)[:, None]
    want = np.zeros((s, d))
    np.add.at(want, pos[mask], np.repeat(scale, f, axis=0)[mask.reshape(-1)])
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-6)


def test_block_sddmm_matches_decode(small_graph=None):
    from legion.ops.segment import block_sddmm
    rng = np.random.default_rng(2)
    p, f, s, d = 6, 3, 12, 8
    pos = rng.integers(0, s, size=(p, f)).astype(np.int32)
    mask = rng.random((p, f)) > 0.3
    h_src = rng.standard_normal((s, d)).astype(np.float32)
    blk = Block(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(mask),
                num_src=jnp.int32(s), num_dst=jnp.int32(p))
    out = np.asarray(block_sddmm(jnp.asarray(h_src[:p]),
                                 jnp.asarray(h_src), blk))
    for i in range(p):
        for j in range(f):
            want = h_src[i] @ h_src[pos[i, j]] if mask[i, j] else 0.0
            np.testing.assert_allclose(out[i, j], want, rtol=1e-5,
                                       atol=1e-6)
