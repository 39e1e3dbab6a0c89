"""Kg-striped hot feature cache: hot rows interleaved across the chips
of a cache group, hits served by collectives, misses staged from host.

This is the reference's signature scaling mechanism. In
Legion, the hot feature rows selected by the cost model are interleaved
round-robin across the ``Kg`` GPUs of an NVLink clique — hot rank
``idx`` lives on GPU ``idx % Kg`` at local slot ``idx / Kg``
(``InitPair`` value ``(idx % Kg) * cap + idx / Kg``,
``src/GPUCache.cu:103-108``; fill ``FeatFillUp`` ``:128-141``) — and the
gather kernel reads remote stripes through peer P2P pointer tables,
falling back to pinned host memory on misses
(``zero_copy_with_aggregated_cache``, ``src/Kernels.cu:662-702``).

Here the same striping is served by collectives over the ``cache`` mesh
axis (XLA lowers them to NCCL over NVLink), not by peer loads: the (tiny, int32) sorted
hot-id array is replicated per chip (the BGHT id->slot map analog, which
Legion also replicates per GPU, ``src/GPUCache.cu:84-86``), each chip
holds stripe ``me`` of the hot rows, and a hit lookup is

    all_gather(hit ranks) -> local gather of the ranks I own
    -> psum_scatter returns each chip its own rows

(see parallel.feature_exchange.sharded_row_fetch — the identical
exchange, here applied to the HOT SUBSET instead of the full table, which
is what makes the cache useful when features exceed aggregate HBM).
Misses are compacted per chip and staged from host RAM exactly as in the
single-chip FeatureCache; both legs are byte-metered.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.feature_cache import CachePlan, FeatureCache
from legion.parallel.feature_exchange import (
    owner_cap, route_by_owner, shard_rows, sharded_row_fetch)


class StripedFeatureCache(NamedTuple):
    """Mesh-placed striped hot cache.

    hot_ids: (C,) int32 sorted global ids, REPLICATED on every chip.
    rows: (K*cap, D) hot rows flattened stripe-major, sharded
        ``P('cache')`` — chip j of each cache group holds stripe j =
        hot rows with rank % K == j (rank = index into hot_ids).
    miss_cap: per-chip staging capacity (rows per step).
    """

    hot_ids: jnp.ndarray
    rows: jnp.ndarray
    miss_cap: int
    group_size: int
    # Per-owner exchange cap (rows each chip may request from one
    # owner per fetch). None = the static fallback owner_cap(M, K)
    # at slack 2.0; drivers that probe the built cache set it to
    # ~1.05x the observed per-owner maximum (probed_owner_cap) —
    # exchange volume then ~= the requested rows, the reference's
    # exactly-requested-bytes P2P bar (src/Kernels.cu:695-699).
    # Over-cap hits always DEMOTE to host staging (metered), so a
    # tight cap costs hit rate, never correctness.
    owner_cap_rows: int | None = None

    @property
    def capacity(self) -> int:
        return int(self.hot_ids.shape[0])

    @classmethod
    def build(cls, host_features: np.ndarray, hot_order: np.ndarray,
              capacity: int, miss_cap: int, mesh,
              dtype=np.float32,
              owner_cap_rows: int | None = None) -> "StripedFeatureCache":
        """Select the top-``capacity`` hot rows (whole cache group's
        capacity — the cost model's ``group_size``-multiplied budget) and
        stripe them over the mesh's ``cache`` axis.

        The per-chip HBM cost is ``capacity/K`` rows plus the replicated
        ``capacity`` int32 hot-id array."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        k = mesh.shape["cache"]
        capacity = int(min(capacity, len(hot_order)))
        hot = np.sort(np.asarray(hot_order[:capacity], np.int32))
        table = np.ascontiguousarray(host_features[hot]).astype(dtype)
        striped = shard_rows(table, k)                    # (K, cap, D)
        flat = striped.reshape(k * striped.shape[1], striped.shape[2])
        rows = jax.device_put(flat, NamedSharding(mesh, P("cache")))
        hot_ids = jax.device_put(
            jnp.asarray(hot), NamedSharding(mesh, P()))
        if owner_cap_rows is not None:
            assert owner_cap_rows > 0, owner_cap_rows
        if k <= 1:
            # a 1-chip cache axis never exchanges: plan_ids skips the
            # over-cap demotion there, so the fetch must not cap either
            # (an orphaned cap would silently zero hits ranked past it
            # — the demotion mask and the fetch routing must agree)
            owner_cap_rows = None
        return cls(hot_ids=hot_ids, rows=rows, miss_cap=int(miss_cap),
                   group_size=int(k),
                   owner_cap_rows=(None if owner_cap_rows is None
                                   else int(owner_cap_rows)))

    # -- jit/shard_map pieces -------------------------------------------
    #
    # Pure functions; cache arrays are ARGUMENTS (never closures — see
    # FeatureCache's jit discipline note). All of them must run INSIDE
    # shard_map with the `cache` axis mapped.

    @staticmethod
    def plan_ids(hot_ids: jnp.ndarray, frontier: jnp.ndarray,
                 miss_cap: int, k: int = 1,
                 cap: int | None = None) -> CachePlan:
        """Per-chip hit/miss classification. plan.slot is the hot RANK
        (owner = rank % K, local slot = rank // K).

        k > 1: hits whose owner chip would exceed the exact exchange's
        per-owner cap (``cap``; default the static fallback) are DEMOTED
        to misses, so they are host-staged instead of returning zero
        rows — the striped path is correct under ANY owner skew (staged
        rows equal cached rows value-for-value: both are
        host_features[id] in the cache dtype). Demotions show up as a
        lower hit rate / more host bytes, never as wrong features.
        k == 1 is exactly the single-chip plan. The SAME cap must be
        passed to combine_rows (the demotion mask and the fetch routing
        must agree)."""
        plan = FeatureCache.plan_ids(hot_ids, frontier, miss_cap)
        if k <= 1:
            return plan
        return StripedFeatureCache.demote_overflow(plan, frontier,
                                                   miss_cap, k, cap)

    @staticmethod
    def demote_overflow(plan: CachePlan, frontier: jnp.ndarray,
                        miss_cap: int, k: int,
                        cap: int | None = None) -> CachePlan:
        """Re-plan with over-cap hits turned into misses (see plan_ids).
        ``plan.num_hit - result.num_hit`` is the demoted count."""
        m = frontier.shape[0]
        req = jnp.where(plan.hit, plan.slot, -1)
        _, _, in_cap, _ = route_by_owner(
            req, k, cap if cap is not None else owner_cap(m, k))
        hit = plan.hit & in_cap
        valid = frontier >= 0
        miss = valid & jnp.logical_not(hit)
        midx = jnp.cumsum(miss.astype(jnp.int32)) - 1
        scatter = jnp.where(miss & (midx < miss_cap), midx, miss_cap)
        miss_ids = jnp.full((miss_cap,), -1, jnp.int32).at[scatter].set(
            jnp.where(miss, frontier, -1), mode="drop")
        return CachePlan(
            slot=plan.slot, hit=hit, miss_idx=midx, miss_ids=miss_ids,
            num_miss=jnp.sum(miss.astype(jnp.int32)),
            num_hit=jnp.sum(hit.astype(jnp.int32)),
            num_valid=plan.num_valid)

    @staticmethod
    def combine_rows(rows_local: jnp.ndarray, plan: CachePlan,
                     staged: jnp.ndarray, frontier: jnp.ndarray,
                     axis: str = "cache",
                     cap: int | None = None) -> jnp.ndarray:
        """Merge collective-fetched hit rows and host-staged miss rows
        into the frontier's feature matrix (the striped twin of
        FeatureCache.combine_rows; identical output given the same hot
        set). Must run inside shard_map with `axis` mapped.

        rows_local: (cap, D) this chip's stripe. staged: (miss_cap, D)
        this chip's staged miss rows. ``cap`` MUST match the plan's
        demotion cap (plan_ids/demote_overflow) so no surviving hit can
        overflow the fetch routing."""
        req = jnp.where(plan.hit, plan.slot, -1)
        hit_rows = sharded_row_fetch(rows_local, req, axis,
                                     cap=cap)             # (M, D)
        mcap = staged.shape[0]
        in_range = plan.miss_idx < mcap
        missed = jnp.take(staged, jnp.clip(plan.miss_idx, 0, mcap - 1),
                          axis=0)
        missed = missed * in_range[:, None].astype(missed.dtype)
        x = jnp.where(plan.hit[:, None], hit_rows.astype(missed.dtype),
                      missed)
        return x * (frontier >= 0)[:, None].astype(x.dtype)

    # -- host piece -------------------------------------------------------

    def np_dtype(self):
        import ml_dtypes
        return (ml_dtypes.bfloat16 if self.rows.dtype == jnp.bfloat16
                else np.float32)


class StripedTopoCache(NamedTuple):
    """Hot adjacency sub-CSR striped across the cache axis.

    The reference stripes hot TOPOLOGY over the clique exactly like
    features (``InitIndexPair``/``InitOffsetPair``,
    ``src/GPUCache.cu:88-100``; sub-CSR build ``GraphCache``,
    ``src/GPU_Memory_Graph_Storage.cu:98-133``) and samples remote rows
    through replicated peer pointer tables. Here hot rank ``r`` (index
    into the sorted replicated ``hot_ids``) lives on chip ``r % K`` at
    local sub-CSR row ``r // K``; a sampling hop is the halo-exchange
    pattern (parallel.halo.partitioned_sample_hop) applied to the hot
    subset: all_gather the frontier's hit ranks, each chip draws fanout
    samples for the rows it owns, psum_scatter returns each chip its own
    frontier's draws. Misses fall to the host sampler (hybrid path).

    hot_ids: (C,) int32 sorted, replicated.
    sub_indptr: (K, rows_cap+1) int32, sharded P('cache') on axis 0.
    sub_indices: (K, edges_cap) int32, sharded P('cache') on axis 0.
    """

    hot_ids: jnp.ndarray
    sub_indptr: jnp.ndarray
    sub_indices: jnp.ndarray

    @classmethod
    def build(cls, indptr: np.ndarray, indices: np.ndarray,
              hot_order: np.ndarray, capacity: int,
              mesh) -> "StripedTopoCache":
        from jax.sharding import NamedSharding, PartitionSpec as P
        k = mesh.shape["cache"]
        capacity = int(min(capacity, len(hot_order)))
        hot = np.sort(np.asarray(hot_order[:capacity], np.int64))
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)

        stripes = []
        rows_cap = edges_cap = 0
        for j in range(k):
            own = hot[j::k]                         # ranks r==j (mod k)
            degs = indptr[own + 1] - indptr[own]
            sp = np.zeros(len(own) + 1, np.int64)
            np.cumsum(degs, out=sp[1:])
            total = int(sp[-1])
            assert total < 2 ** 31, "hot sub-CSR stripe exceeds int32"
            within = np.arange(total, dtype=np.int64) - np.repeat(
                sp[:-1], degs)
            src = np.repeat(indptr[own], degs) + within
            si = indices[src].astype(np.int32)
            stripes.append((sp, si))
            rows_cap = max(rows_cap, len(own))
            edges_cap = max(edges_cap, total)

        sub_indptr = np.zeros((k, rows_cap + 1), np.int32)
        sub_indices = np.full((k, max(edges_cap, 1)), -1, np.int32)
        for j, (sp, si) in enumerate(stripes):
            sub_indptr[j, : len(sp)] = sp
            sub_indptr[j, len(sp):] = sp[-1]        # pad rows: degree 0
            sub_indices[j, : len(si)] = si
        sh = NamedSharding(mesh, P("cache"))
        return cls(
            hot_ids=jax.device_put(jnp.asarray(hot.astype(np.int32)),
                                   NamedSharding(mesh, P())),
            sub_indptr=jax.device_put(jnp.asarray(sub_indptr), sh),
            sub_indices=jax.device_put(jnp.asarray(sub_indices), sh))

    @staticmethod
    def lookup(hot_ids: jnp.ndarray, ids: jnp.ndarray):
        """(hit, rank) for global ids (-1 padded); jit-safe."""
        c = hot_ids.shape[0]
        valid = ids >= 0
        safe = jnp.where(valid, ids, 0)
        pos = jnp.clip(jnp.searchsorted(hot_ids, safe).astype(jnp.int32),
                       0, max(c - 1, 0))
        hit = valid & (hot_ids[pos] == safe) if c > 0 else \
            jnp.zeros_like(valid)
        return hit, pos

    @staticmethod
    def sample_hot(hot_ids: jnp.ndarray, sub_indptr_local: jnp.ndarray,
                   sub_indices_local: jnp.ndarray, key: jax.Array,
                   frontier: jnp.ndarray, fanout: int,
                   axis: str = "cache", cap: int | None = None):
        """One hop for the cache-hit subset of the frontier, striped.

        Must run inside shard_map with `axis` mapped; the local stripe
        arrays carry their (1, ...) leading mesh axis. Returns
        (neighbors (M, fanout) int32 with -1 for invalid-or-miss,
        hit (M,) bool). Draw semantics match TopoCache.sample_hot
        (uniform with replacement, slot >= degree -> -1); on a 1-chip
        mesh the draws are bit-identical to it given the same key.

        Exchange: requests routed to their owner chips by all_to_all
        with a static per-owner cap (parallel.feature_exchange), draws
        returned directly — ~owner_cap_slack x the requested bytes
        instead of the K x psum_scatter volume of the v1 exchange. The
        request's GLOBAL index rides along as payload so the owner
        draws u[(requester, j)] from the same (K*M, fanout) grid as v1
        — draws are bit-identical across exchange strategies AND group
        sizes, PROVIDED every chip of the cache group passes the SAME
        key (the u grid is group-wide; StripedHybridTrainer therefore
        folds only the data axis into this hop's key, never the cache
        axis). Requests beyond the owner cap are DEMOTED to misses
        (hit=False) and fall to the host sampler: correct under any
        skew, visible as a lower hot fraction.
        """
        sp = sub_indptr_local[0]
        si = sub_indices_local[0]
        k = jax.lax.axis_size(axis)
        me = jax.lax.axis_index(axis)
        m = frontier.shape[0]
        if cap is None:
            cap = owner_cap(m, k)

        hit, rank = StripedTopoCache.lookup(hot_ids, frontier)
        req = jnp.where(hit, rank, -1)
        gidx = me * m + jnp.arange(m, dtype=jnp.int32)   # v1 grid index
        send, pos, in_cap, _, send_gidx = route_by_owner(
            req, k, cap, payload=gidx)
        recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=True)
        recv_g = jax.lax.all_to_all(send_gidx, axis, 0, 0, tiled=True)

        rvalid = (recv >= 0).reshape(-1)                 # (k*cap,)
        row = jnp.where(rvalid, recv.reshape(-1) // k, 0)
        start = sp[row]
        deg = jnp.where(rvalid, sp[row + 1] - start, 0)

        # same u grid as the v1 exchange: request (c, j) -> u[c*m + j]
        u = jax.random.uniform(key, (k * m, fanout), dtype=jnp.float32)
        ur = jnp.take(u, jnp.clip(recv_g.reshape(-1), 0, k * m - 1),
                      axis=0)                            # (k*cap, fanout)
        off = jnp.minimum((ur * deg[:, None].astype(jnp.float32))
                          .astype(jnp.int32),
                          jnp.maximum(deg[:, None] - 1, 0))
        addr = jnp.clip(start[:, None] + off, 0, si.shape[0] - 1)
        nbr = si[addr]
        slot = jax.lax.broadcasted_iota(jnp.int32, (k * cap, fanout), 1)
        ok = rvalid[:, None] & (slot < deg[:, None]) & (deg[:, None] > 0)
        draws = jnp.where(ok, nbr, -1).reshape(k, cap, fanout)
        resp = jax.lax.all_to_all(draws, axis, 0, 0, tiled=True)
        flat = resp.reshape(k * cap, fanout)
        safe_owner = jnp.where(req >= 0, req, 0) % k
        out = jnp.take(flat,
                       jnp.clip(safe_owner * cap
                                + jnp.minimum(pos, cap - 1),
                                0, k * cap - 1), axis=0)  # (M, fanout)
        hit = hit & in_cap
        out = jnp.where(hit[:, None], out, -1)
        return out, hit
