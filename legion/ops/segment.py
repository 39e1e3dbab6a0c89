"""Neighborhood aggregation primitives (XLA reference implementations).

The block's dense ``(dst_cap, fanout)`` layout turns SpMM into a row
gather + regular masked reduction — no scatters, no atomics (contrast the
reference's atomic-compaction kernels, ``src/Kernels.cu:412-424``, and the
DGL SpMM the client runs). XLA lowers the gather to a row gather and
fuses the mask/reduce.

All functions are shape-polymorphic in dst_cap/fanout/dim but fully
static under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from legion.sampling.block import Block


def fanout_gather_sum(h_src: jnp.ndarray, block: Block) -> jnp.ndarray:
    """(S, D), Block -> (dst_cap, D): sum of sampled-neighbor features.

    Identity-layout blocks (sampler.append_frontier) skip the random
    gather entirely: their src rows are a contiguous slice of h_src in
    (dst, slot) order, so the "gather" is a reshape.
    """
    p, f = block.nbr_pos.shape
    if block.identity_offset is not None:
        # Left to XLA on purpose: it fuses this reduce with the feature
        # gather that produces h_src, so the appended rows never reach
        # memory. A Pallas kernel here forces them to (measured: PERF.md).
        off = block.identity_offset
        rows = h_src[off:off + p * f].reshape(p, f, -1)
    else:
        rows = jnp.take(h_src, block.nbr_pos, axis=0)      # (P, f, D)
    m = block.nbr_mask[..., None].astype(h_src.dtype)
    return jnp.sum(rows * m, axis=1)


def fanout_gather_mean(h_src: jnp.ndarray, block: Block) -> jnp.ndarray:
    """Mean aggregation; zero-in-degree dst rows yield 0 (the reference
    model relies on DGL's same convention via allow_zero_in_degree)."""
    s = fanout_gather_sum(h_src, block)
    cnt = jnp.sum(block.nbr_mask, axis=1, keepdims=True).astype(h_src.dtype)
    return s / jnp.maximum(cnt, 1.0)


def segment_mean_coo(h_src: jnp.ndarray, block: Block) -> jnp.ndarray:
    """Scatter-based mean aggregation over the flattened COO edge list —
    the DGL/torch-style SpMM formulation the reference client executes.
    Kept as (a) the vs_baseline reference for benchmarks and (b) a
    cross-check oracle for the gather-based path."""
    src, dst, mask = block.coo()
    msgs = jnp.take(h_src, src, axis=0) * mask[:, None].astype(h_src.dtype)
    summ = jax.ops.segment_sum(msgs, dst, num_segments=block.dst_cap)
    cnt = jax.ops.segment_sum(mask.astype(h_src.dtype), dst,
                              num_segments=block.dst_cap)
    return summ / jnp.maximum(cnt, 1.0)[:, None]


def block_dst_degree(block: Block) -> jnp.ndarray:
    """(dst_cap,) in-degree of each dst within the block."""
    return jnp.sum(block.nbr_mask, axis=1).astype(jnp.int32)


def block_src_out_degree(block: Block, src_cap: int) -> jnp.ndarray:
    """(src_cap,) out-degree of each src within the block (needed by the
    GCN 'both' norm). One scatter-add of ones — small (int per node).
    Identity-layout blocks need no scatter: each appended row has exactly
    one edge (its own slot) and rows before the offset have none."""
    if block.identity_offset is not None:
        # Left to XLA on purpose: it fuses this reduce with the feature
        # gather that produces h_src, so the appended rows never reach
        # memory. A Pallas kernel here forces them to (measured: PERF.md).
        off = block.identity_offset
        flat = block.nbr_mask.astype(jnp.int32).reshape(-1)
        assert off + flat.shape[0] == src_cap
        return jnp.concatenate([jnp.zeros((off,), jnp.int32), flat])
    ones = block.nbr_mask.astype(jnp.int32).reshape(-1)
    pos = jnp.where(block.nbr_mask, block.nbr_pos, src_cap).reshape(-1)
    deg = jnp.zeros((src_cap,), jnp.int32)
    return deg.at[pos].add(ones, mode="drop")


def block_sddmm(h_dst: jnp.ndarray, h_src: jnp.ndarray,
                block: Block) -> jnp.ndarray:
    """Sampled-dense-dense matmul over a block's edges:
    out[d, j] = <h_dst[d], h_src[block.nbr_pos[d, j]]> (0 where masked).

    The edge-score primitive for attention/link models (GAT-style
    alpha, LP edge scoring). The (dst, fanout) grid makes it a row
    gather + batched contraction — no COO scatter. Identity-layout
    blocks skip the gather (contiguous slice + reshape)."""
    p, f = block.nbr_pos.shape
    if block.identity_offset is not None:
        # Left to XLA on purpose: it fuses this reduce with the feature
        # gather that produces h_src, so the appended rows never reach
        # memory. A Pallas kernel here forces them to (measured: PERF.md).
        off = block.identity_offset
        rows = h_src[off:off + p * f].reshape(p, f, -1)
    else:
        rows = jnp.take(h_src, block.nbr_pos, axis=0)       # (P, f, D)
    scores = jnp.einsum("pd,pfd->pf", h_dst[:p].astype(jnp.float32),
                        rows.astype(jnp.float32))
    return jnp.where(block.nbr_mask, scores, 0.0)
