"""Hybrid device/host sampling for graphs whose CSR exceeds HBM.

The reference reads the full CSR zero-copy from pinned host memory in
GPU threads and short-circuits hot rows to a device sub-CSR
(``kernel_random_sampler_2``'s partition branch, ``src/Kernels.cu:
387-397`` + GraphCache). Here the split is explicit per hop:

  device: sample hot frontier nodes from the HBM sub-CSR (TopoCache)
  host:   sample the misses from the mmap'd CSR (C++ runtime, threaded)
  device: merge + dedup/renumber (grow_frontier)

The host leg costs one device->host fetch of (frontier, hit) and one
host->device staging of the cold draws per hop — the PCIe-zero-copy
analog, explicit and byte-metered. Hotness caching keeps the host leg
small (that is the whole point of the topology cache's cost-model
share).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from legion.cache.topo_cache import TopoCache
from legion.sampling.block import SampledBatch
from legion.sampling.sampler import grow_frontier


class HybridSampler:
    def __init__(self, topo: TopoCache, host_indptr: np.ndarray,
                 host_indices: np.ndarray, fanouts: Sequence[int],
                 caps: Sequence[int]):
        self.topo = topo
        self.host_indptr = np.ascontiguousarray(host_indptr, np.int64)
        self.host_indices = np.ascontiguousarray(host_indices, np.int32)
        self.fanouts = tuple(fanouts)
        self.caps = tuple(caps)
        self.stats = {"hot": 0, "cold": 0, "host_bytes": 0}

        # TopoCache is a NamedTuple pytree: pass it as a traced ARGUMENT
        # (jitting the bound method would bake the sub-CSR arrays into
        # the program as literal constants — GBs for large caches).
        self._jit_hot = jax.jit(TopoCache.sample_hot, static_argnums=(3,))
        self._jit_grow = jax.jit(grow_frontier, static_argnums=(3,))
        self._jit_merge = jax.jit(
            lambda hot, cold, hit: jnp.where(hit[:, None], hot, cold))

    def sample_batch(self, key: jax.Array, seeds: jnp.ndarray,
                     num_seeds, labels: jnp.ndarray,
                     host_seed: int | None = None) -> SampledBatch:
        if host_seed is None:
            # derive the host leg's seed from the device key so repeated
            # calls vary the cold draws too — a fixed default would
            # silently replay identical host-side neighbors every batch
            # (the production trainers thread an explicit per-step seed;
            # this guards the naive exported API)
            try:
                kd = jax.random.key_data(key)
            except Exception:
                kd = key
            host_seed = int(np.asarray(kd).ravel()[-1]) & 0x7FFFFFFF
        caps = self.caps
        frontier = jnp.full((caps[0],), -1, jnp.int32).at[
            : seeds.shape[0]].set(seeds)
        num = jnp.asarray(num_seeds, jnp.int32)
        blocks = []
        for k, fanout in enumerate(self.fanouts):
            key, sub = jax.random.split(key)
            nbrs_hot, hit = self._jit_hot(self.topo, sub, frontier, fanout)
            # host leg for the cache misses
            hit_np = np.asarray(hit)
            frontier_np = np.asarray(frontier)
            miss_ids = np.where(~hit_np & (frontier_np >= 0),
                                frontier_np, -1).astype(np.int32)
            from legion import runtime
            cold = runtime.sample_neighbors(
                self.host_indptr, self.host_indices, miss_ids, fanout,
                seed=host_seed * 1_000_003 + k)
            self.stats["hot"] += int(hit_np.sum())
            ncold = int((miss_ids >= 0).sum())
            self.stats["cold"] += ncold
            self.stats["host_bytes"] += ncold * fanout * 4
            nbrs = self._jit_merge(nbrs_hot, jnp.asarray(cold), hit)
            frontier, num, blk = self._jit_grow(frontier, num, nbrs,
                                                caps[k + 1])
            blocks.append(blk)

        return SampledBatch(
            seeds=seeds, labels=labels,
            num_seeds=jnp.asarray(num_seeds, jnp.int32),
            frontier=frontier, num_frontier=num, blocks=tuple(blocks))

    def hot_fraction(self) -> float:
        t = self.stats["hot"] + self.stats["cold"]
        return self.stats["hot"] / t if t else float("nan")


class HybridTrainer:
    """Pipelined hybrid training: host-CSR sampling legs batched into ONE
    packed device->host transfer per hop, with batch i+1's first hop
    piggybacked on batch i's finish program so its host leg overlaps the
    device train step — the two-stream sample/train overlap of the
    reference runner (``src/Server.cu:310-316``) recast as async
    dispatch.

    Per-step transfer budget (H hops): H device->host fetches (one
    packed array per hop; the feature plan and the NEXT batch's hop-0
    plan share the last one) vs 2H+1 for the naive per-hop
    hit+frontier+plan fetches of HybridSampler (2.5x fewer at H=2),
    plus the unavoidable H+1 host->device stagings. Fetches are counted
    in ``stats["fetches"]`` so tests can assert the budget.

    Step structure (H=2):

      [held from last step] hop-0 hot draws + packed miss ids
      host: sample cold hop-0 rows         [overlaps train(i-1) on device]
      dev:  j_step(merge, dedup, sample hot hop-1)   -> packed miss ids
      host: fetch, sample cold hop-1 rows
      dev:  j_finish(merge, dedup, feature plan; hop-0 of batch i+1)
      host: fetch (feat stats+miss ids | next hop-0 pack), stage rows
      dev:  train step (async)
    """

    def __init__(self, cfg, model, caps, topo: TopoCache,
                 host_indptr: np.ndarray, host_indices: np.ndarray,
                 fcache, host_stage=None):
        from legion.cache.feature_cache import FeatureCache
        from legion.cache.pipeline import make_cache_step_fns
        from legion.sampling.block import SampledBatch

        self.cfg = cfg
        self.topo = topo
        self.host_indptr = np.ascontiguousarray(host_indptr, np.int64)
        self.host_indices = np.ascontiguousarray(host_indices, np.int32)
        self.fanouts = tuple(cfg.sampler.fanouts)
        self.caps = tuple(caps)
        self.fcache = fcache
        self.host_stage = host_stage or fcache.stage
        self.is_lp = cfg.model.arch == "lp_sage"
        self._SampledBatch = SampledBatch
        self.stats = {"hot": 0, "cold": 0, "host_topo_bytes": 0,
                      "fetches": 0}
        caps = self.caps
        fanouts = self.fanouts
        miss_cap = fcache.miss_cap
        H = len(fanouts)

        def pack_hop(frontier, hit):
            """[n_hot | miss ids (-1 where hot/pad)] — one fetch serves
            the host sampler AND the hot/cold metering."""
            miss = jnp.where(jnp.logical_not(hit) & (frontier >= 0),
                             frontier, -1)
            return jnp.concatenate(
                [jnp.sum(hit.astype(jnp.int32))[None], miss])

        def j_start(topo, key, seeds, num_seeds):
            frontier = jnp.full((caps[0],), -1, jnp.int32).at[
                : seeds.shape[0]].set(seeds)
            nbrs_hot, hit = TopoCache.sample_hot(
                topo, jax.random.fold_in(key, 0), frontier, fanouts[0])
            return (frontier, num_seeds.astype(jnp.int32), nbrs_hot, hit,
                    pack_hop(frontier, hit))

        def j_step(k):  # hop k in [1, H-1]
            def f(topo, key, frontier, num, nbrs_hot, hit, cold):
                nbrs = jnp.where(hit[:, None], nbrs_hot, cold)
                frontier, num, blk = grow_frontier(frontier, num, nbrs,
                                                   caps[k])
                nh, h2 = TopoCache.sample_hot(
                    topo, jax.random.fold_in(key, k), frontier, fanouts[k])
                return frontier, num, blk, nh, h2, pack_hop(frontier, h2)
            return jax.jit(f)

        def j_finish(topo, hot_ids_feat, key_next, seeds_next, num_next,
                     frontier, num, nbrs_hot, hit, cold):
            nbrs = jnp.where(hit[:, None], nbrs_hot, cold)
            frontier, num, blk = grow_frontier(frontier, num, nbrs,
                                               caps[H])
            plan = FeatureCache.plan_ids(hot_ids_feat, frontier, miss_cap)
            packed_feat = jnp.concatenate([
                jnp.stack([plan.num_hit, plan.num_miss, plan.num_valid,
                           plan.overflow()]),
                plan.miss_ids])
            nxt = j_start(topo, key_next, seeds_next, num_next)
            packed = jnp.concatenate([packed_feat, nxt[4]])
            return frontier, num, blk, plan, nxt[:4], packed

        self._j_start = jax.jit(j_start)
        self._j_steps = [j_step(k) for k in range(1, H)]
        self._j_finish = jax.jit(j_finish)
        train_from, eval_from = make_cache_step_fns(cfg, model)
        self._jit_train = jax.jit(train_from, donate_argnums=(0,))
        self._jit_eval = jax.jit(eval_from)

    # -- host legs ----------------------------------------------------------

    def _fetch(self, packed) -> np.ndarray:
        self.stats["fetches"] += 1
        return np.asarray(packed)

    def _cold(self, miss_pack: np.ndarray, fanout: int, seed: int):
        """miss_pack: [n_hot | miss ids]. Returns (cold draws, n_cold)."""
        from legion import runtime
        miss = miss_pack[1:]
        cold = runtime.sample_neighbors(self.host_indptr,
                                        self.host_indices, miss, fanout,
                                        seed=seed)
        n_cold = int((miss >= 0).sum())
        self.stats["hot"] += int(miss_pack[0])
        self.stats["cold"] += n_cold
        self.stats["host_topo_bytes"] += n_cold * fanout * 4
        return jnp.asarray(cold), n_cold

    def _advance(self, carry, packed0: np.ndarray, key, seed_base: int,
                 key_next, seeds_next, num_next):
        """Run hops 1..H-1 + finish for the batch whose hop-0 state is
        `carry`/`packed0`. Returns (batch, plan, staged, next_carry,
        next_packed0)."""
        frontier, num, nbrs_hot, hit = carry
        blocks = []
        for k in range(1, len(self.fanouts)):
            cold, _ = self._cold(packed0, self.fanouts[k - 1],
                                 seed_base * 131 + k - 1)
            frontier, num, blk, nbrs_hot, hit, packed = self._j_steps[
                k - 1](self.topo, key, frontier, num, nbrs_hot, hit, cold)
            blocks.append(blk)
            packed0 = self._fetch(packed)
        cold, _ = self._cold(packed0, self.fanouts[-1],
                             seed_base * 131 + len(self.fanouts) - 1)
        frontier, num, blk, plan, nxt, packed = self._j_finish(
            self.topo, self.fcache.hot_ids, key_next, seeds_next,
            num_next, frontier, num, nbrs_hot, hit, cold)
        blocks.append(blk)
        fused = self._fetch(packed)
        feat_pack = fused[: 4 + self.fcache.miss_cap]
        next_pack = fused[4 + self.fcache.miss_cap:]
        staged = jnp.asarray(self.host_stage(feat_pack[4:]))
        return blocks, frontier, num, plan, feat_pack[:4], staged, \
            nxt, next_pack

    def run_epoch(self, state, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray, epoch: int):
        import time as _t
        steps, b = seeds_epoch.shape
        key = jax.random.fold_in(state.rng, epoch)
        nb = jnp.full((), b, jnp.int32)
        t0 = _t.perf_counter()
        # self.stats accumulates for the trainer's lifetime (train + eval
        # epochs alike); report THIS epoch's deltas, not the running total.
        stats0 = dict(self.stats)
        losses, cap_overflow = [], []
        feat_stats = np.zeros(4, np.int64)
        host_feat_bytes = 0
        itemsize = np.dtype(self.fcache.np_dtype).itemsize
        dim = self.fcache.host_features.shape[1]

        k0 = jax.random.fold_in(key, 0)
        carry = self._j_start(self.topo, k0, jnp.asarray(seeds_epoch[0]),
                              nb)
        packed0 = self._fetch(carry[4])
        carry = carry[:4]
        for i in range(steps):
            k_i = jax.random.fold_in(key, i)
            k_n = jax.random.fold_in(key, (i + 1) % steps)
            seeds_next = jnp.asarray(seeds_epoch[(i + 1) % steps])
            blocks, frontier, num, plan, fstats, staged, carry, packed0 \
                = self._advance(carry, packed0, k_i,
                                epoch * 1_000_003 + i, k_n, seeds_next,
                                nb)
            batch = self._SampledBatch(
                seeds=jnp.asarray(seeds_epoch[i]),
                labels=jnp.asarray(labels_epoch[i]),
                num_seeds=nb, frontier=frontier, num_frontier=num,
                blocks=tuple(blocks))
            state, m = self._jit_train(state, self.fcache.rows, batch,
                                       plan, staged)
            # batch i+1's hop-0 host leg runs NOW, while the device
            # executes train(i) (async dispatch) — the overlap window.
            losses.append(m["loss"])
            cap_overflow.append(m["cap_overflow"])
            feat_stats += fstats.astype(np.int64)
            host_feat_bytes += (min(int(fstats[1]), self.fcache.miss_cap)
                                * dim * itemsize)
            from legion.train.train_state import maybe_checkpoint_step
            maybe_checkpoint_step(self.cfg.train, state, i)

        losses, cap_overflow = jax.device_get((losses, cap_overflow))
        dt = _t.perf_counter() - t0
        return {
            "state": state, "steps": steps, "seconds": dt,
            "first_loss": float(losses[0]) if losses else float("nan"),
            "loss": float(losses[-1]) if losses else float("nan"),
            "cap_overflow": int(sum(cap_overflow)),
            "feat_hit_rate": float(feat_stats[0]) / max(float(
                feat_stats[2]), 1.0),
            "staging_overflow": int(feat_stats[3]),
            "host_feat_gb": host_feat_bytes / 2 ** 30,
            "host_topo_gb": (self.stats["host_topo_bytes"]
                             - stats0["host_topo_bytes"]) / 2 ** 30,
            "topo_hot_fraction": (
                (self.stats["hot"] - stats0["hot"])
                / max((self.stats["hot"] - stats0["hot"])
                      + (self.stats["cold"] - stats0["cold"]), 1)),
            "fetches": self.stats["fetches"] - stats0["fetches"],
        }

    def eval_epoch(self, params, seeds: np.ndarray, counts: np.ndarray,
                   labels: np.ndarray, key=None) -> float:
        """Deterministic eval through the hybrid sampling + cached
        feature path (the reference's per-epoch valid / final test,
        ``legion_graphsage.py:159-181``)."""
        key = key if key is not None else jax.random.PRNGKey(4242)
        # accumulate on device; ONE fetch at the end
        a_acc = jnp.zeros((), jnp.float32)
        b_acc = jnp.zeros((), jnp.float32)
        steps = seeds.shape[0]
        if steps == 0:
            return float("nan")
        k0 = jax.random.fold_in(key, 0)
        carry = self._j_start(self.topo, k0, jnp.asarray(seeds[0]),
                              jnp.full((), int(counts[0]), jnp.int32))
        packed0 = self._fetch(carry[4])
        carry = carry[:4]
        for t in range(steps):
            k_t = jax.random.fold_in(key, t)
            k_n = jax.random.fold_in(key, (t + 1) % steps)
            blocks, frontier, num, plan, fstats, staged, carry, packed0 \
                = self._advance(carry, packed0, k_t, 777_000 + t, k_n,
                                jnp.asarray(seeds[(t + 1) % steps]),
                                jnp.full((), int(counts[(t + 1) % steps]),
                                         jnp.int32))
            batch = self._SampledBatch(
                seeds=jnp.asarray(seeds[t]), labels=jnp.asarray(labels[t]),
                num_seeds=jnp.full((), int(counts[t]), jnp.int32),
                frontier=frontier, num_frontier=num, blocks=tuple(blocks))
            a, bb = self._jit_eval(params, self.fcache.rows, batch, plan,
                                   staged)
            a_acc = a_acc + a.astype(jnp.float32)
            b_acc = b_acc + bb.astype(jnp.float32)
        # LP and accuracy aggregate identically (sum / count) — see
        # train.loop.lp_logsigmoid_sum
        a_sum = float(jax.device_get(a_acc))
        return a_sum / max(float(jax.device_get(b_acc)), 1.0)
