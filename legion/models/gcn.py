"""GCN over sampled blocks.

Mirrors the reference client — a DGL ``GraphConv`` stack with
``allow_zero_in_degree=True`` (``pytorch_extension/legion_gcn.py:68-96``):
symmetric 'both' normalization computed on the block,
``h' = D_dst^{-1/2} A (D_src^{-1/2} h) W + b``, with activation inside
every layer but the last, and dropout before every layer but the first.
Zero-in-degree dst rows produce 0 (no NaN), matching allow_zero_in_degree.

Parameters are a plain dict ``{"layer_i": {"dense": {kernel}, "bias"}}``
with the same ``init``/``apply`` call shape as models.sage.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from legion.models.nn import dense, dense_init, dropout
from legion.ops.segment import (block_dst_degree, block_src_out_degree,
                                fanout_gather_sum)
from legion.sampling.block import Block


def graph_conv_init(key: jax.Array, in_dim: int, out_dim: int) -> dict:
    return {"dense": dense_init(key, in_dim, out_dim, use_bias=False),
            "bias": jnp.zeros((out_dim,), jnp.float32)}


def graph_conv(p: dict, block: Block, h_src: jnp.ndarray,
               dtype=jnp.float32) -> jnp.ndarray:
    bias = p["bias"].astype(dtype)
    dst_deg = block_dst_degree(block).astype(dtype)
    dst_norm = jax.lax.rsqrt(jnp.maximum(dst_deg, 1.0))[:, None]
    if block.identity_offset is not None:
        # Identity blocks: every appended src row carries at most one
        # edge, so the src 1/sqrt(out-deg) factor is exactly 1 and
        # 'both' norm reduces to sum / sqrt(in-deg).
        agg = fanout_gather_sum(h_src.astype(dtype), block) * dst_norm
        return dense(p["dense"], agg, dtype) + bias
    src_deg = block_src_out_degree(block, h_src.shape[0]).astype(dtype)
    h = h_src * (1.0 / jnp.sqrt(jnp.maximum(src_deg, 1.0)))[:, None]
    # The kernel (bias-free) commutes exactly with the masked sum and
    # the per-row dst scaling, so when it NARROWS and the block gathers
    # (non-identity layout), transform before aggregation to shrink the
    # random row gather + backward scatter (same move as sage_conv);
    # bias is added after the norm either way.
    if p["dense"]["kernel"].shape[1] < h_src.shape[-1]:
        agg = fanout_gather_sum(dense(p["dense"], h, dtype), block)
    else:
        agg = dense(p["dense"], fanout_gather_sum(h, block), dtype)
    # Zero-degree rows: both guards give factor 1 on a zero sum, so the
    # result is exactly 0 (DGL allow_zero_in_degree behavior).
    return agg * dst_norm + bias


@dataclasses.dataclass(frozen=True)
class GCN:
    hidden_dim: int
    out_dim: int
    num_layers: int = 2
    dropout: float = 0.5
    dtype: jnp.dtype = jnp.float32

    def init(self, key: jax.Array, blocks: Sequence[Block], x: jnp.ndarray,
             deterministic: bool = True) -> dict:
        dims = ([x.shape[-1]] + [self.hidden_dim] * (self.num_layers - 1)
                + [self.out_dim])
        keys = jax.random.split(key, self.num_layers)
        return {"params": {f"layer_{i}": graph_conv_init(keys[i], dims[i],
                                                         dims[i + 1])
                           for i in range(self.num_layers)}}

    def apply(self, variables: dict, blocks: Sequence[Block],
              x: jnp.ndarray, deterministic: bool = True,
              rngs: Optional[dict] = None) -> jnp.ndarray:
        assert len(blocks) == self.num_layers
        params = variables["params"]
        key = (rngs or {}).get("dropout")
        # identity-layout first block: the layer casts what it aggregates
        # (see models.sage); skip the whole-array cast.
        h = (x if blocks and blocks[0].identity_offset is not None
             else x.astype(self.dtype))
        for i, block in enumerate(blocks):
            if i != 0:
                h = dropout(h, self.dropout,
                            None if key is None
                            else jax.random.fold_in(key, i),
                            deterministic)
            h = graph_conv(params[f"layer_{i}"], block, h, self.dtype)
            if i != self.num_layers - 1:
                h = jax.nn.relu(h)
        return h
