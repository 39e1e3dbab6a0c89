"""Static-shape message-flow-graph blocks.

Replaces the reference's dynamic sampled buffers + counter protocol
(``src/Kernels.cu:112-150``, ``pytorch_extension/ipc_cuda_kernel.cu:198-229``)
with fixed-capacity pytrees + valid-count scalars, so the whole sampling ->
training path is one XLA program.

Node numbering keeps the reference/DGL prefix invariant: the frontier after
hop k is ``[seeds, hop1-new, ..., hopk-new]`` and the dst nodes of a block
are exactly the first ``num_dst`` src nodes (reference fills
``sampled_ids``/``position_map`` cumulatively, ``src/Kernels.cu:434-439``).
So ``h_dst = h_src[:dst_cap]`` — no dst index indirection in the model.

Edges are NOT stored as a COO scatter list. Because every dst samples at
most ``fanout`` neighbors, a block is a dense ``(dst_cap, fanout)`` grid of
src positions + a validity mask: aggregation becomes a row gather plus a
regular masked reduction over the fanout axis — no scatter/atomic-based
SpMM (reference
``src/Kernels.cu:412-424`` uses global atomics; XLA segment_sum would use
scatter-adds).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import dataclasses

import jax
import jax.numpy as jnp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def frontier_caps(batch_size: int, fanouts: Sequence[int],
                  align: int = 8) -> Tuple[int, ...]:
    """Static frontier capacities per hop.

    cap_0 = batch; cap_k = cap_{k-1} * (1 + fanouts[k-1]) — every node of
    the previous frontier plus all its sampled neighbors (the reference's
    ``max_ids_num`` bound, ``src/Server.cu:184-196``, made exact). Rounded
    up to ``align``.
    """
    caps = [_round_up(batch_size, align)]
    for f in fanouts:
        caps.append(_round_up(caps[-1] * (1 + f), align))
    return tuple(caps)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Block:
    """One bipartite message-flow block (hop k): src = frontier after the
    hop, dst = frontier before it (a prefix of src)."""

    # (dst_cap, fanout) int32: position of each sampled neighbor in the
    # src frontier array; arbitrary (clipped) where invalid.
    nbr_pos: jnp.ndarray
    # (dst_cap, fanout) bool: slot holds a real sampled edge.
    nbr_mask: jnp.ndarray
    num_src: jnp.ndarray      # () int32 valid src extent (see identity_offset)
    num_dst: jnp.ndarray      # () int32 valid dst nodes
    # Static layout promise for un-deduped hops (sampler.append_frontier):
    # when set, nbr_pos[d, j] == identity_offset + d*fanout + j identically,
    # so aggregation is a contiguous slice+reshape — no random gather and
    # (because such blocks are only ever the LAST hop, whose src features
    # carry no gradient) no backward scatter. num_src is then the occupied
    # extent identity_offset + dst_cap*fanout, which may exceed the count
    # of valid rows (invalid slots leave -1 holes in the frontier).
    identity_offset: Optional[int] = dataclasses.field(
        default=None, metadata=dict(static=True))

    @property
    def dst_cap(self) -> int:
        return self.nbr_pos.shape[0]

    @property
    def fanout(self) -> int:
        return self.nbr_pos.shape[1]

    def num_edges(self) -> jnp.ndarray:
        """Valid edge count (reference edge_counter analog)."""
        return jnp.sum(self.nbr_mask.astype(jnp.int32))

    def coo(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Flatten to (src_pos, dst_pos, mask) COO — for parity tests and
        ops that genuinely need an edge list (e.g. GCN degree norms)."""
        dst = jnp.broadcast_to(
            jnp.arange(self.dst_cap, dtype=jnp.int32)[:, None],
            self.nbr_pos.shape)
        return self.nbr_pos.reshape(-1), dst.reshape(-1), self.nbr_mask.reshape(-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """Everything the train step needs for one mini-batch.

    ``blocks`` are in *sampling* order (hop 1 from the seeds first); models
    consume ``reversed(blocks)`` so the outermost hop feeds the first
    layer (reference client order, ``legion_graphsage.py:77-79``).
    """

    seeds: jnp.ndarray          # (seed_cap,) int32 global ids, -1 padded
    labels: jnp.ndarray         # (seed_cap,) int32, -1 padded
    num_seeds: jnp.ndarray      # () int32
    frontier: jnp.ndarray       # (final_cap,) int32 global ids, -1 padded
    num_frontier: jnp.ndarray   # () int32
    blocks: Tuple[Block, ...]

    @property
    def seed_cap(self) -> int:
        return self.seeds.shape[0]

    @property
    def frontier_cap(self) -> int:
        return self.frontier.shape[0]

    def seed_mask(self) -> jnp.ndarray:
        return jnp.arange(self.seed_cap, dtype=jnp.int32) < self.num_seeds

    def cap_overflow(self) -> jnp.ndarray:
        """() int32: frontier ids the static caps dropped, summed over
        the hops (mode="drop" silently thins sampled neighborhoods — the
        failure mode of a too-tight cap slack). Hop k's cap is the dst
        cap of block k+1 (the final frontier's for the last block);
        identity-appended blocks are exact by construction."""
        caps = [b.dst_cap for b in self.blocks[1:]] + [self.frontier_cap]
        over = jnp.zeros((), jnp.int32)
        for blk, cap in zip(self.blocks, caps):
            if blk.identity_offset is None:
                over = over + jnp.maximum(blk.num_src - cap, 0)
        return over
