"""GraphSAGE (mean aggregator) over sampled blocks.

Numerics mirror the reference client model — a DGL ``SAGEConv('mean')``
stack (``pytorch_extension/legion_graphsage.py:37-64``): per layer
``h' = W_self h_dst + W_neigh mean_{u in sampled N(dst)} h_u + b`` with
bias on the self path only (DGL convention), ReLU + dropout between
layers, none after the last.

Blocks arrive in model order (outermost hop first); the dst nodes of each
block are the first ``dst_cap`` rows of the src activations (prefix
invariant, see sampling.block).

Parameters are a plain dict ``{"layer_i": {"fc_self": {kernel, bias},
"fc_neigh": {kernel}}}``; ``init``/``apply`` keep the
``model.init(key, blocks, x)["params"]`` /
``model.apply({"params": p}, blocks, x, deterministic=..., rngs=...)``
call shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from legion.models.nn import dense, dense_init, dropout
from legion.ops.segment import fanout_gather_mean, segment_mean_coo
from legion.sampling.block import Block

# Aggregator registry: "fanout" is the gather+reduce path; "coo_segment"
# is the scatter-based DGL-style SpMM kept as benchmark baseline and
# cross-check (same numerics).
AGGREGATORS = {"fanout": fanout_gather_mean, "coo_segment": segment_mean_coo}


def sage_conv_init(key: jax.Array, in_dim: int, out_dim: int) -> dict:
    k_self, k_neigh = jax.random.split(key)
    return {"fc_self": dense_init(k_self, in_dim, out_dim, use_bias=True),
            "fc_neigh": dense_init(k_neigh, in_dim, out_dim,
                                   use_bias=False)}


def sage_conv(p: dict, block: Block, h_src: jnp.ndarray,
              dtype=jnp.float32, agg: str = "fanout") -> jnp.ndarray:
    h_dst = h_src[: block.dst_cap]
    out_dim = p["fc_neigh"]["kernel"].shape[1]
    # fc_neigh has no bias and mean is linear, so it commutes with
    # aggregation exactly. When it NARROWS (out < in) and the block
    # gathers (non-identity layout), transforming src activations first
    # shrinks both the forward row gather and the backward scatter-add by
    # in/out (e.g. 256->47: ~5x fewer random-access bytes) for a few
    # extra matmul FLOPs. Identity-layout blocks aggregate a contiguous
    # slice (no gather), where transform-first would only inflate the
    # dense work.
    if (agg == "fanout" and block.identity_offset is None
            and out_dim < h_src.shape[-1]):
        h_neigh = AGGREGATORS[agg](dense(p["fc_neigh"], h_src, dtype), block)
    else:
        h_neigh = dense(p["fc_neigh"], AGGREGATORS[agg](h_src, block), dtype)
    return dense(p["fc_self"], h_dst, dtype) + h_neigh


@dataclasses.dataclass(frozen=True)
class SAGE:
    hidden_dim: int
    out_dim: int
    num_layers: int = 2
    dropout: float = 0.5
    dtype: jnp.dtype = jnp.float32
    agg: str = "fanout"

    def init(self, key: jax.Array, blocks: Sequence[Block], x: jnp.ndarray,
             deterministic: bool = True) -> dict:
        dims = ([x.shape[-1]] + [self.hidden_dim] * (self.num_layers - 1)
                + [self.out_dim])
        keys = jax.random.split(key, self.num_layers)
        return {"params": {f"layer_{i}": sage_conv_init(keys[i], dims[i],
                                                        dims[i + 1])
                           for i in range(self.num_layers)}}

    def apply(self, variables: dict, blocks: Sequence[Block],
              x: jnp.ndarray, deterministic: bool = True,
              rngs: Optional[dict] = None) -> jnp.ndarray:
        assert len(blocks) == self.num_layers
        params = variables["params"]
        key = (rngs or {}).get("dropout")
        # An identity-layout first block aggregates the raw features in
        # place, so skip the whole-array cast (a full extra pass over the
        # largest tensor in the step); dense layers cast their own inputs.
        if not (self.agg == "fanout" and blocks
                and blocks[0].identity_offset is not None):
            x = x.astype(self.dtype)
        h = x
        for i, block in enumerate(blocks):
            h = sage_conv(params[f"layer_{i}"], block, h, self.dtype,
                          self.agg)
            if i != self.num_layers - 1:
                h = jax.nn.relu(h)
                h = dropout(h, self.dropout,
                            None if key is None
                            else jax.random.fold_in(key, i),
                            deterministic)
        return h
