"""Hotness-ordered feature cache: hot rows in HBM, misses staged from
host RAM.

Replaces the reference's BGHT-cuckoo-hash feature cache
(``PreSCCacheController::FindFeat`` + ``zero_copy_with_aggregated_cache``,
``src/GPUCache.cu:387-432``, ``src/Kernels.cu:662-702``): the cache is
static after the presampling phase, so a *sorted* hot-id array +
``searchsorted`` is a perfect hash — no buckets, no atomics, and the
lookup vectorizes. Misses read pinned-host feature rows;
here they are compacted on device, gathered on host (numpy/C++ runtime)
and staged back — the zero-copy-over-PCIe analog, made explicit and
therefore exactly accountable (bytes moved = num_miss x row bytes).

Hit/miss statistics are returned as scalars every step (the reference
prints them every 500th iteration, ``src/GPUCache.cu:414-425``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def cache_dtype_for(model_dtype: str, feature_dim: int):
    """(numpy storage dtype, bytes per cached row) for a model compute
    dtype — the single place the bf16-cache policy lives: bf16 training
    stores cache rows + staged misses in bf16 (2x rows per HBM budget,
    half the host->device bytes; the model casts x to bf16 anyway)."""
    if model_dtype == "bfloat16":
        import ml_dtypes
        return ml_dtypes.bfloat16, feature_dim * 2
    return np.float32, feature_dim * 4


class CachePlan(NamedTuple):
    slot: jnp.ndarray        # (M,) int32 cache slot (valid where hit)
    hit: jnp.ndarray         # (M,) bool
    miss_idx: jnp.ndarray    # (M,) int32 UNCLAMPED miss rank (valid where miss;
    #                          rows with rank >= miss_cap overflowed staging
    #                          and combine_rows zeroes them)
    miss_ids: jnp.ndarray    # (miss_cap,) int32 global ids to stage, -1 pad
    num_miss: jnp.ndarray    # () int32 total misses (may exceed miss_cap)
    num_hit: jnp.ndarray     # () int32
    num_valid: jnp.ndarray   # () int32

    def overflow(self) -> jnp.ndarray:
        """Misses beyond staging capacity (their rows read as zeros)."""
        return jnp.maximum(self.num_miss - self.miss_ids.shape[0], 0)


class FeatureCache:
    """Host features + HBM hot-row cache.

    hot_ids must be sorted ascending (build() handles it). rows[i] =
    features[hot_ids[i]].
    """

    def __init__(self, hot_ids: jnp.ndarray, rows: jnp.ndarray,
                 host_features: np.ndarray, miss_cap: int):
        self.hot_ids = hot_ids
        self.rows = rows
        self.host_features = host_features
        self.miss_cap = int(miss_cap)

    @property
    def np_dtype(self):
        import ml_dtypes
        return (ml_dtypes.bfloat16 if self.rows.dtype == jnp.bfloat16
                else np.float32)

    @classmethod
    def build(cls, host_features: np.ndarray, hot_order: np.ndarray,
              capacity: int, miss_cap: int,
              dtype=np.float32) -> "FeatureCache":
        """hot_order: hotness-descending candidate ids (cost-model
        feat_order); the top `capacity` are cached (FillUp analog,
        src/GPUCache.cu:769-826).

        dtype: on-device storage/staging dtype. Training in bf16 makes
        bf16 the natural choice — it DOUBLES the rows a given HBM budget
        caches and HALVES host->device staging bytes, and the model
        casts x to bf16 anyway (pass the cost model feat_row_bytes =
        dim * 2 to match)."""
        capacity = int(min(capacity, len(hot_order)))
        hot = np.sort(np.asarray(hot_order[:capacity], np.int32))
        rows = np.ascontiguousarray(host_features[hot]).astype(dtype)
        return cls(jnp.asarray(hot), jnp.asarray(rows), host_features,
                   miss_cap)

    # -- jitted pieces ------------------------------------------------------
    #
    # The pure functions take the cache arrays as ARGUMENTS. Do NOT close
    # over self.hot_ids/self.rows inside a jitted function: closed-over
    # device arrays are baked into the XLA program as literal constants
    # (a ~1GB feature cache overflows compile-request limits and bloats
    # every program). The bound methods below are trace-safe only when
    # the instance arrays are passed through jit as inputs.

    @staticmethod
    def plan_ids(hot_ids: jnp.ndarray, frontier: jnp.ndarray,
                 miss_cap: int) -> CachePlan:
        """Classify each frontier id as cache hit or miss and compact the
        miss ids for host staging. Jit-safe; hot_ids sorted ascending."""
        c = hot_ids.shape[0]
        valid = frontier >= 0
        ids = jnp.where(valid, frontier, 0)
        pos = jnp.searchsorted(hot_ids, ids).astype(jnp.int32)
        posc = jnp.clip(pos, 0, max(c - 1, 0))
        hit = valid & (hot_ids[posc] == ids) if c > 0 else jnp.zeros_like(valid)
        miss = valid & jnp.logical_not(hit)

        midx = jnp.cumsum(miss.astype(jnp.int32)) - 1
        scatter = jnp.where(miss & (midx < miss_cap), midx, miss_cap)
        miss_ids = jnp.full((miss_cap,), -1, jnp.int32)
        miss_ids = miss_ids.at[scatter].set(
            jnp.where(miss, frontier, -1), mode="drop")
        return CachePlan(
            slot=posc, hit=hit, miss_idx=midx,
            miss_ids=miss_ids,
            num_miss=jnp.sum(miss.astype(jnp.int32)),
            num_hit=jnp.sum(hit.astype(jnp.int32)),
            num_valid=jnp.sum(valid.astype(jnp.int32)))

    @staticmethod
    def combine_rows(rows: jnp.ndarray, plan: CachePlan, staged: jnp.ndarray,
                     frontier: jnp.ndarray) -> jnp.ndarray:
        """Merge cached rows and staged miss rows into the frontier's
        feature matrix. staged: (miss_cap, D) rows for plan.miss_ids.
        Padded frontier slots (-1) and overflowed misses (rank beyond
        staging capacity — see CachePlan.overflow) come out zero."""
        cap = staged.shape[0]
        cached = jnp.take(rows, plan.slot, axis=0)
        in_range = plan.miss_idx < cap
        missed = jnp.take(staged, jnp.clip(plan.miss_idx, 0, cap - 1),
                          axis=0)
        missed = missed * in_range[:, None].astype(missed.dtype)
        x = jnp.where(plan.hit[:, None], cached, missed)
        return x * (frontier >= 0)[:, None].astype(x.dtype)

    def plan(self, frontier: jnp.ndarray) -> CachePlan:
        return self.plan_ids(self.hot_ids, frontier, self.miss_cap)

    def combine(self, plan: CachePlan, staged: jnp.ndarray,
                frontier: jnp.ndarray) -> jnp.ndarray:
        return self.combine_rows(self.rows, plan, staged, frontier)

    # -- host piece ---------------------------------------------------------

    def stage(self, miss_ids: np.ndarray) -> np.ndarray:
        """Host-side gather of miss rows (numpy fallback; the C++ runtime
        provides a threaded version — legion.runtime). Rows are
        returned in the cache dtype so staging bytes match it."""
        ids = np.asarray(miss_ids)
        safe = np.clip(ids, 0, self.host_features.shape[0] - 1)
        rows = self.host_features[safe].astype(self.np_dtype)
        rows[ids < 0] = 0.0
        return rows
