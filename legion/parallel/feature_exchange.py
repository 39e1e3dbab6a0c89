"""Striped feature storage + cross-chip row exchange over a mesh axis.

Replaces the reference's NVLink clique cache reads: there, hot feature
rows are interleaved round-robin across the Kg GPUs of a clique
(``InitPair`` value ``(idx % Kg) * cap + idx / Kg``,
``src/GPUCache.cu:103-108``) and remote rows are read through peer P2P
pointer tables (``zero_copy_with_aggregated_cache``,
``src/Kernels.cu:695-699``). Here the same striping is served by
collectives over the ``cache`` mesh axis.

Two exchange strategies:

* **exact** (default, ``sharded_row_fetch``): requests are grouped by
  owner chip (owner = id % K; sort-based grouping) into a (K, C) send
  buffer with a
  static per-owner cap C, ``all_to_all``'d to the owners, served by a
  local gather, and ``all_to_all``'d straight back — each response row
  crosses the interconnect exactly ONCE, so collective volume is ~slack x the
  requested rows, matching the reference's P2P reads which move exactly
  the requested bytes (``src/Kernels.cu:695-699``). The cap is
  ``ceil(M/K) x owner_cap_slack``; round-robin striping spreads a
  frontier's hit ranks near-uniformly over owners mod K, and requests
  beyond the cap return ZERO rows with the overflow COUNTED (same
  static-caps-plus-overflow-metric contract as the frontier caps) —
  callers surface ``overflow`` and a persistent overflow means the
  slack must be raised.
* **v1** (``sharded_row_fetch_psum``): all_gather(ids) + local gather +
  psum_scatter(rows). K x the ideal volume (every chip's full request
  set rides the reduce-scatter) but cap-free and oblivious to owner
  skew. Kept as the fallback/oracle. (The halo path, where a uniform
  per-owner cap genuinely does not hold, got its own exact form in r5:
  per-ring-distance ppermute rounds with non-uniform caps —
  parallel.halo.partitioned_row_fetch_exact.)

Closed-form per-step collective bytes for both live in
``legion.utils.comm`` and are asserted against compiled HLO in
tests/test_comm_accounting.py.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Static per-owner request-cap slack over the uniform share ceil(M/K) —
# the PROBE-FREE FALLBACK. Round-robin ownership makes per-owner counts
# concentrate tightly at hit_count/K <= M/K; 2x absorbs skew while still
# cutting exchange volume by K/2 vs the psum path (K=4: 2x fewer bytes;
# K=8: 4x). Drivers that can probe the built cache size the cap from
# OBSERVED per-owner maxima instead (probed_owner_cap, slack ~1.05),
# taking the exchange to ~1.05x the requested rows — the reference's
# P2P bar (exactly requested bytes, src/Kernels.cu:695-699) within 5%.
OWNER_CAP_SLACK = 2.0

# Slack over the observed per-owner maximum when the cap is probe-sized
# (the frontier-cap discipline: probe, cap at ~1.05x, assert/meter
# overflow loudly — here over-cap requests DEMOTE to the host path, so
# a burst costs hit rate, never correctness).
PROBED_OWNER_SLACK = 1.05


def owner_cap(m: int, k: int, slack: float = OWNER_CAP_SLACK) -> int:
    """Per-owner send-buffer rows for M requests over K owners,
    8-aligned, never below 8 or above M."""
    c = int(-(-m // k) * slack)
    return max(8, min((c + 7) // 8 * 8, m))


def probed_cap(observed_max: int, hi: int,
               slack: float = PROBED_OWNER_SLACK) -> int:
    """Cap from an OBSERVED request maximum: slack x observed + a small
    absolute floor for burst headroom, 8-aligned, clamped to [8, hi].
    The single formula behind every probe-sized exchange cap (striped
    owner caps AND the halo per-distance caps) so headroom policy lives
    in one place."""
    c = int(observed_max * slack) + 32
    return max(8, min((c + 7) // 8 * 8, int(hi)))


def probed_owner_cap(observed_max: int, m: int, k: int,
                     slack: float = PROBED_OWNER_SLACK) -> int:
    """Owner cap from an OBSERVED per-owner request maximum (never
    above the static fallback). Binomial concentration makes the
    realized per-owner counts fluctuate by ~sqrt(H/K) around H/K, so
    ~1.05x the observed max across a few probe batches holds with
    demotion as the loud backstop (metered as exchange_overflow)."""
    return probed_cap(observed_max, owner_cap(m, k), slack)


def owner_counts(ids: jnp.ndarray, k: int) -> jnp.ndarray:
    """(k,) int32 per-owner request counts for owner = id % k (valid ids
    only). The probe primitive behind probed_owner_cap; jit-safe."""
    valid = ids >= 0
    owner = jnp.where(valid, ids, 0) % k
    return jnp.sum(
        ((owner[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :])
         & valid[:, None]).astype(jnp.int32), axis=0)


def shard_rows(table: np.ndarray, k: int) -> np.ndarray:
    """Stripe rows round-robin: global row r -> shard r % k, slot r // k.

    Returns (k, ceil(N/k), D); feed shard i to mesh position i along the
    cache axis. Same interleave as the reference's InitPair/FeatFillUp
    (src/GPUCache.cu:103-108, :128-141).
    """
    n, d = table.shape
    cap = -(-n // k)
    out = np.zeros((k, cap, d), dtype=table.dtype)
    for i in range(k):
        rows = table[i::k]
        out[i, : rows.shape[0]] = rows
    return out


def route_by_owner(ids: jnp.ndarray, k: int, cap: int,
                   payload: jnp.ndarray | None = None):
    """Group requests by owner chip (owner = id % k) into a (k, cap)
    send buffer, -1 padded, preserving request order within each owner
    group. Pure function of ids; jit-safe.

    Returns (send (k, cap) int32, pos (M,) int32 within-owner index of
    each request, in_cap (M,) bool — False where the request overflowed
    its owner's cap (or was padding), overflow () int32 count[, routed
    payload (k, cap) int32 when ``payload`` (M,) is given — carried
    through the same grouping, 0-filled on empty slots]).

    Built sort-free where possible: the within-owner position is a
    one-hot exclusive cumsum (M x k int32 — small), and the send buffer
    is one KV sort of (owner, id[, payload]) + a (k*cap,) gather, so
    at[...].set is avoided.
    """
    m = ids.shape[0]
    valid = ids >= 0
    safe = jnp.where(valid, ids, 0)
    owner = jnp.where(valid, safe % k, k)

    oh = (owner[:, None] == jnp.arange(k, dtype=jnp.int32)[None, :])
    ohc = oh.astype(jnp.int32)
    csum = jnp.cumsum(ohc, axis=0)                       # inclusive
    pos = jnp.take_along_axis(csum - ohc,
                              jnp.minimum(owner, k - 1)[:, None],
                              axis=1)[:, 0]              # exclusive
    counts = csum[-1]                                    # (k,)
    overflow = jnp.sum(jnp.maximum(counts - cap, 0)).astype(jnp.int32)

    # grouped ids: one stable KV sort by owner (padding sorts last)
    ops = ([owner, ids] if payload is None
           else [owner, ids, payload.astype(jnp.int32)])
    sorted_ops = jax.lax.sort(ops, num_keys=1, is_stable=True)
    s_ids = sorted_ops[1]
    start = jnp.cumsum(counts) - counts                  # (k,)
    o_grid = jax.lax.broadcasted_iota(jnp.int32, (k, cap), 0)
    p_grid = jax.lax.broadcasted_iota(jnp.int32, (k, cap), 1)
    idx = jnp.clip(start[o_grid] + p_grid, 0, max(m - 1, 0))
    filled = p_grid < counts[o_grid]
    send = jnp.where(filled, s_ids[idx], -1)
    in_cap = valid & (pos < cap)
    if payload is None:
        return send, pos, in_cap, overflow
    s_pay = sorted_ops[2]
    send_pay = jnp.where(filled, s_pay[idx], 0)
    return send, pos, in_cap, overflow, send_pay


def owner_overflow(ids: jnp.ndarray, k: int, cap: int | None = None
                   ) -> jnp.ndarray:
    """Count of requests the exact exchange would cap (zero rows
    returned): sum over owners of max(count_owner - cap, 0). Cheap
    (one (M, k) one-hot reduction) — computable at PLAN time, before
    any exchange runs, so drivers can meter it alongside the staging
    overflow without changing the exchange's return signature."""
    if cap is None:
        cap = owner_cap(ids.shape[0], k)
    counts = owner_counts(ids, k)
    return jnp.sum(jnp.maximum(counts - cap, 0)).astype(jnp.int32)


def sharded_row_fetch_stats(table_local: jnp.ndarray, ids: jnp.ndarray,
                            axis: str, cap: int | None = None
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact exchange: fetch global rows ``ids`` from a round-robin-
    striped table, each response row crossing the interconnect exactly
    once.

    Must run inside shard_map with ``axis`` mapped. table_local:
    (stripe_rows, D) this chip's stripe (global row r lives on chip
    r % K at slot r // K). ids: (M,) int32 global row ids, -1 padding.
    Returns ((M, D) rows — zeros for padding and for requests beyond
    the per-owner cap, overflow () int32 count of capped requests).
    """
    k = jax.lax.axis_size(axis)
    m = ids.shape[0]
    if cap is None:
        cap = owner_cap(m, k)

    send, pos, in_cap, overflow = route_by_owner(ids, k, cap)
    # requests to their owners: recv[p] = the ids peer p asked ME for
    recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=True)   # (k, cap)
    rvalid = recv >= 0
    slot = jnp.where(rvalid, recv, 0) // k
    rows = jnp.take(table_local,
                    jnp.clip(slot.reshape(-1), 0,
                             table_local.shape[0] - 1), axis=0)
    rows = rows * rvalid.reshape(-1, 1).astype(rows.dtype)
    rows = rows.reshape(k, cap, -1)
    # responses straight back: resp[o, p] = row for MY request (o, p)
    resp = jax.lax.all_to_all(rows, axis, 0, 0, tiled=True)   # (k,cap,D)
    flat = resp.reshape(k * cap, -1)
    safe_owner = jnp.where(ids >= 0, ids, 0) % k
    out = jnp.take(flat,
                   jnp.clip(safe_owner * cap + jnp.minimum(pos, cap - 1),
                            0, k * cap - 1), axis=0)
    out = out * in_cap[:, None].astype(out.dtype)
    return out, overflow


def sharded_row_fetch(table_local: jnp.ndarray, ids: jnp.ndarray,
                      axis: str, cap: int | None = None) -> jnp.ndarray:
    """Exact exchange without the overflow stat (see
    sharded_row_fetch_stats); callers on metered paths should use the
    stats variant and surface the overflow count."""
    return sharded_row_fetch_stats(table_local, ids, axis, cap)[0]


def sharded_row_fetch_psum(table_local: jnp.ndarray, ids: jnp.ndarray,
                           axis: str) -> jnp.ndarray:
    """v1 exchange: all_gather(ids) + local gather + psum_scatter(rows).

    K x the exact exchange's volume (every chip's full request set rides
    the reduce-scatter) but cap-free: correct under ANY owner skew. Used
    by the halo exchange, where ids are partition-owned (not round-robin)
    and per-owner counts are genuinely skewed.
    """
    k = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)

    all_ids = jax.lax.all_gather(ids, axis)              # (K, M)
    valid = all_ids >= 0
    safe = jnp.where(valid, all_ids, 0)
    owner = safe % k
    slot = safe // k
    mine = valid & (owner == me)

    rows = jnp.take(table_local, jnp.clip(slot, 0, table_local.shape[0] - 1),
                    axis=0)                              # (K, M, D)
    rows = rows * mine[..., None].astype(rows.dtype)
    flat = rows.reshape(k * ids.shape[0], -1)
    # reduce-scatter over the cache axis: shard me receives tile me,
    # i.e. the summed responses for ITS requested ids.
    return jax.lax.psum_scatter(flat, axis, scatter_dimension=0, tiled=True)
