"""Mesh-parallel hybrid training: striped hot topology + striped hot
features + threaded host sampler, on a (data x cache) device mesh.

This is the reference's uk2014/clueweb-class configuration — hybrid
sampling (GPU threads reading the pinned-host zero-copy CSR with a
cached sub-CSR short-circuit, ``src/Kernels.cu:387-397,468-564``) with
the clique-striped hot topology (``src/GPUCache.cu:88-100``, sub-CSR
build ``src/GPU_Memory_Graph_Storage.cu:98-133``) and striped hot
features (``src/GPUCache.cu:103-141``) running on ALL GPUs
simultaneously (``src/Server.cu:116-133``) — recast as one SPMD program:

* every chip samples and trains its own sub-batch (DP, the per-GPU
  GPURunner analog), gradients pmean'd across the whole mesh;
* the hot sub-CSR and hot feature rows are striped over the ``cache``
  mesh axis; hot hops/rows are served by collectives
  (StripedTopoCache.sample_hot / StripedFeatureCache.combine_rows);
* frontier nodes missing the topo cache are sampled by the threaded C++
  host sampler; feature-cache misses are host-staged — both legs ride
  ONE packed device->host transfer per hop (the HybridTrainer transfer
  discipline) now carrying every chip's pack;
* batch i+1's hop-0 is computed inside batch i's finish program so its
  host leg overlaps the device train step (cross-batch overlap, the
  two-stream sample/train overlap of ``src/Server.cu:310-316``).

Value-exactness contract (tested): on a 1x1 mesh this trainer matches
the single-chip HybridTrainer — same key schedule, same host sampler
seeds, same draw values; params agree to float rounding (see
cache.striped_pipeline's matching note on the r4 exact exchange).
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from legion.cache.feature_cache import FeatureCache
from legion.cache.striped import StripedFeatureCache, StripedTopoCache
from legion.config import Config
from legion.sampling.sampler import grow_frontier
from legion.train.loop import (lp_logsigmoid_loss, lp_logsigmoid_sum,
                               masked_softmax_ce)
from legion.train.train_state import TrainState

MESH_AXES = ("data", "cache")


def _flat_index():
    return (jax.lax.axis_index("data") * jax.lax.axis_size("cache")
            + jax.lax.axis_index("cache"))


class StripedHybridTrainer:
    """Hybrid sampling + striped caches on a device mesh.

    seeds/labels per step: (n_chips * batch,) int32 — chip c's sub-batch
    at columns [c*b, (c+1)*b) (the striped_pipeline convention).
    """

    def __init__(self, cfg: Config, model, caps, topo: StripedTopoCache,
                 host_indptr: np.ndarray, host_indices: np.ndarray,
                 fcache: StripedFeatureCache, mesh, host_stage=None,
                 topo_owner_caps=None):
        from legion.sampling.block import SampledBatch

        self.cfg = cfg
        self.topo = topo
        self.host_indptr = np.ascontiguousarray(host_indptr, np.int64)
        self.host_indices = np.ascontiguousarray(host_indices, np.int32)
        self.fanouts = tuple(cfg.sampler.fanouts)
        self.caps = tuple(caps)
        self.fcache = fcache
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        # fail at construction, not after presample/cache-build minutes
        # (StripedFeatureCache has no .stage fallback, unlike the
        # single-chip HybridTrainer's cache)
        assert host_stage is not None, (
            "StripedHybridTrainer needs host_stage (the host-RAM miss "
            "stager, e.g. FeatureCache.stage)")
        self.host_stage = host_stage
        self.is_lp = cfg.model.arch == "lp_sage"
        self._SampledBatch = SampledBatch
        self.stats = {"hot": 0, "cold": 0, "host_topo_bytes": 0,
                      "fetches": 0, "edges": 0, "topo_demoted": 0}

        caps = self.caps
        fanouts = self.fanouts
        miss_cap = fcache.miss_cap
        n = self.n_shards
        H = len(fanouts)
        # per-owner exchange caps: probed by the driver (~1.05x observed
        # per-owner maxima, see striped_hybrid_driver) or None = static
        # 2x fallback. tcaps[k] bounds hop k's sample_hot routing; the
        # feature cap feeds both the plan demotion and the fetch (they
        # must agree). Over-cap requests demote to the host path.
        tcaps = tuple(topo_owner_caps) if topo_owner_caps \
            else (None,) * H
        assert len(tcaps) == H, (tcaps, H)
        ocap_feat = fcache.owner_cap_rows
        self.topo_owner_caps = tcaps
        self._rep = NamedSharding(mesh, P())
        self._shard = NamedSharding(mesh, P(MESH_AXES))
        ax = P(MESH_AXES)
        topo_sp = (P(), P("cache"), P("cache"))   # hot_ids, indptr, indices

        def fold_shard(key):
            # skipped on a 1-chip mesh: bit-identical key schedule to the
            # single-chip HybridTrainer
            if n > 1:
                key = jax.random.fold_in(key, _flat_index())
            return key

        def fold_data(key):
            # cache-group-SHARED key for the hot-hop exchange: the u
            # grid of sample_hot spans the whole group (v1 grid, one
            # row per (chip, slot) request), so intra-group consistency
            # — and the "draws bit-identical across group sizes"
            # contract — requires ONE key per cache group; decorrelate
            # only across the data axis. (A per-chip fold here made the
            # owner draw from a different u table than the requester's
            # grid index refers to: still uniform, but Kg-dependent.)
            # Skipped when the data axis is 1 (bit-identical schedule
            # to the single-chip HybridTrainer at 1x1).
            if mesh.shape["data"] > 1:
                key = jax.random.fold_in(
                    key, jax.lax.axis_index("data"))
            return key

        def hot_hop(hot_t, sp, si, key, k, frontier, fanout):
            """(draws, hit, demoted): ``demoted`` counts the hot rows
            past the exchange's per-owner cap, sampled on the host
            instead."""
            # hop key: fold_in(batch_key, hop) [HybridTrainer schedule],
            # then data-axis-only decorrelation (see fold_data)
            hk = fold_data(jax.random.fold_in(key, k))
            nbrs, hit = StripedTopoCache.sample_hot(hot_t, sp, si, hk,
                                                    frontier, fanout,
                                                    cap=tcaps[k])
            hot, _ = StripedTopoCache.lookup(hot_t, frontier)
            demoted = jnp.sum(hot.astype(jnp.int32)) - jnp.sum(
                hit.astype(jnp.int32))
            return nbrs, hit, demoted

        def pack_hop(frontier, hit, edges, demoted):
            """[n_hot, prev-block edges, topology demotions | miss ids
            (-1 where hot/pad)] — one fetch serves the host sampler AND
            the hot/cold/edge metering."""
            miss = jnp.where(jnp.logical_not(hit) & (frontier >= 0),
                             frontier, -1)
            return jnp.concatenate(
                [jnp.sum(hit.astype(jnp.int32))[None],
                 jnp.asarray(edges, jnp.int32)[None], demoted[None],
                 miss])

        def start_logic(hot_t, sp, si, key, seeds, num_seeds):
            frontier = jnp.full((caps[0],), -1, jnp.int32).at[
                : seeds.shape[0]].set(seeds)
            nbrs_hot, hit, dem = hot_hop(hot_t, sp, si, key, 0, frontier,
                                         fanouts[0])
            return (frontier, num_seeds.astype(jnp.int32), nbrs_hot, hit,
                    pack_hop(frontier, hit, 0, dem))

        lift = lambda t: jax.tree.map(lambda a: a[None], t)  # noqa: E731
        drop = lambda t: jax.tree.map(lambda a: a[0], t)     # noqa: E731

        def j_start(hot_t, sp, si, key, seeds, num_seeds):
            out = start_logic(hot_t, sp, si, key, seeds[0], num_seeds[0])
            return lift(out[:4]), out[4][None]

        def j_step(k):  # hop k in [1, H-1]
            def f(hot_t, sp, si, key, frontier, num, nbrs_hot, hit, cold):
                frontier, num, nbrs_hot, hit, cold = drop(
                    (frontier, num, nbrs_hot, hit, cold))
                nbrs = jnp.where(hit[:, None], nbrs_hot, cold)
                frontier, num, blk = grow_frontier(frontier, num, nbrs,
                                                   caps[k])
                nh, h2, dem = hot_hop(hot_t, sp, si, key, k, frontier,
                                      fanouts[k])
                return lift((frontier, num, blk, nh, h2,
                             pack_hop(frontier, h2, blk.num_edges(), dem)))
            return f

        def j_finish(hot_t, sp, si, feat_hot, key_next, seeds_next,
                     num_next, frontier, num, nbrs_hot, hit, cold):
            frontier, num, nbrs_hot, hit, cold = drop(
                (frontier, num, nbrs_hot, hit, cold))
            nbrs = jnp.where(hit[:, None], nbrs_hot, cold)
            frontier, num, blk = grow_frontier(frontier, num, nbrs,
                                               caps[H])
            # over-cap hits demoted to host-staged misses (exact-exchange
            # contract, StripedFeatureCache.plan_ids); the demoted count
            # is metered like the striped cache trainer's
            base = StripedFeatureCache.plan_ids(feat_hot, frontier,
                                                miss_cap)
            kx = jax.lax.axis_size("cache")
            plan = (StripedFeatureCache.demote_overflow(
                base, frontier, miss_cap, kx, cap=ocap_feat)
                if kx > 1 else base)
            packed_feat = jnp.concatenate([
                jnp.stack([plan.num_hit, plan.num_miss, plan.num_valid,
                           plan.overflow(), blk.num_edges(),
                           base.num_hit - plan.num_hit]),
                plan.miss_ids])
            nxt = start_logic(hot_t, sp, si, key_next, seeds_next[0],
                              num_next[0])
            packed = jnp.concatenate([packed_feat, nxt[4]])
            return lift((frontier, num, blk, plan)) + (lift(nxt[:4]),
                                                       packed[None])

        def train_from(state: TrainState, rows_local, batch, plan, staged):
            batch = drop(batch)
            plan = drop(plan)
            staged = staged[0]

            def loss_fn(params, dkey):
                x = StripedFeatureCache.combine_rows(
                    rows_local, plan, staged, batch.frontier,
                    axis="cache", cap=ocap_feat)
                blocks = tuple(reversed(batch.blocks))
                out = model.apply({"params": params}, blocks, x,
                                  deterministic=False,
                                  rngs={"dropout": dkey})
                out = out[: batch.seed_cap]
                mask = batch.seed_mask()
                if self.is_lp:
                    return lp_logsigmoid_loss(out, mask)
                return masked_softmax_ce(out, batch.labels, mask)

            key = fold_shard(jax.random.fold_in(state.rng, state.step))
            _, dkey = jax.random.split(key)
            loss, grads = jax.value_and_grad(loss_fn)(state.params, dkey)
            # already psummed by the vma transpose (see train.loop);
            # divide for the DDP mean — /1 on a 1x1 mesh (bit-match)
            grads = jax.tree.map(lambda g: g / n, grads)
            loss = jax.lax.pmean(loss, MESH_AXES)
            state = state.apply_gradients(grads)
            # per-chip frontier ids the static caps dropped (summed on
            # the host: no extra collective in the step)
            return state, loss, batch.cap_overflow()[None]

        def eval_from(params, rows_local, batch, plan, staged):
            batch = drop(batch)
            plan = drop(plan)
            staged = staged[0]
            x = StripedFeatureCache.combine_rows(
                rows_local, plan, staged, batch.frontier,
                axis="cache", cap=ocap_feat)
            blocks = tuple(reversed(batch.blocks))
            out = model.apply({"params": params}, blocks, x,
                              deterministic=True)
            out = out[: batch.seed_cap]
            mask = batch.seed_mask()
            if self.is_lp:
                # (loss SUM, valid-pair count): a/b after the psum is
                # the pair-weighted mean across shards AND steps
                a, b = lp_logsigmoid_sum(out, mask)
            else:
                pred = jnp.argmax(out, axis=-1)
                a, b = jnp.sum((pred == batch.labels) & mask), jnp.sum(mask)
            a = jax.lax.psum(a.astype(jnp.float32), MESH_AXES)
            b = jax.lax.psum(b.astype(jnp.float32), MESH_AXES)
            return a, b

        sm = lambda f, ins, outs: jax.shard_map(  # noqa: E731
            f, mesh=mesh, in_specs=ins, out_specs=outs)
        carry4 = (ax, ax, ax, ax)
        self._j_start = jax.jit(sm(
            j_start, topo_sp + (P(), ax, ax), (carry4, ax)))
        self._j_steps = [jax.jit(sm(
            j_step(k), topo_sp + (P(),) + carry4 + (ax,),
            (ax, ax, ax, ax, ax, ax))) for k in range(1, H)]
        self._j_finish = jax.jit(sm(
            j_finish, topo_sp + (P(), P(), ax, ax) + carry4 + (ax,),
            (ax, ax, ax, ax, carry4, ax)))
        self.jit_train_from = jax.jit(sm(
            train_from, (P(), P("cache"), ax, ax, ax), (P(), P(), ax)),
            donate_argnums=(0,))
        self.jit_eval_from = jax.jit(sm(
            eval_from, (P(), P("cache"), ax, ax, ax), (P(), P())))

    # -- host pieces ----------------------------------------------------------

    def _placed(self, a):
        return jax.device_put(jnp.asarray(a), self._shard)

    def _rep_put(self, a):
        return jax.device_put(a, self._rep)

    def _fetch(self, packed) -> np.ndarray:
        """ONE device->host transfer carrying every chip's pack."""
        self.stats["fetches"] += 1
        return np.asarray(packed)

    def _cold(self, miss_pack: np.ndarray, fanout: int, seed: int):
        """miss_pack: (n, 3 + M) per-chip [n_hot, prev-block edges,
        topology demotions | miss ids]. Samples all chips' cold rows in
        one threaded C++ call; returns a sharded (n, M, fanout) device
        array."""
        from legion import runtime
        n = self.n_shards
        miss = np.ascontiguousarray(miss_pack[:, 3:]).reshape(-1)
        cold = runtime.sample_neighbors(self.host_indptr,
                                        self.host_indices, miss, fanout,
                                        seed=seed)
        n_cold = int((miss >= 0).sum())
        self.stats["hot"] += int(miss_pack[:, 0].sum())
        self.stats["cold"] += n_cold
        self.stats["edges"] += int(miss_pack[:, 1].sum())
        self.stats["topo_demoted"] += int(miss_pack[:, 2].sum())
        self.stats["host_topo_bytes"] += n_cold * fanout * 4
        return self._placed(cold.reshape(n, -1, fanout))

    def _advance(self, carry, packed0: np.ndarray, key, seed_base: int,
                 key_next, seeds_next, num_next):
        """Hops 1..H-1 + finish for the batch whose hop-0 state is
        `carry`/`packed0` (both per-chip). Returns (blocks, frontier,
        num, plan, feat stats (n,6), staged, next_carry, next_packed0)."""
        frontier, num, nbrs_hot, hit = carry
        n = self.n_shards
        blocks = []
        for k in range(1, len(self.fanouts)):
            cold = self._cold(packed0, self.fanouts[k - 1],
                              seed_base * 131 + k - 1)
            frontier, num, blk, nbrs_hot, hit, packed = self._j_steps[
                k - 1](self.topo.hot_ids, self.topo.sub_indptr,
                       self.topo.sub_indices, key, frontier, num,
                       nbrs_hot, hit, cold)
            blocks.append(blk)
            packed0 = self._fetch(packed)
        cold = self._cold(packed0, self.fanouts[-1],
                          seed_base * 131 + len(self.fanouts) - 1)
        frontier, num, blk, plan, nxt, packed = self._j_finish(
            self.topo.hot_ids, self.topo.sub_indptr,
            self.topo.sub_indices, self.fcache.hot_ids, key_next,
            seeds_next, num_next, frontier, num, nbrs_hot, hit, cold)
        blocks.append(blk)
        fused = self._fetch(packed)                      # (n, 6+mc+3+c0)
        mc = self.fcache.miss_cap
        # hit, miss, valid, overflow, edges, exchange demotions
        feat_stats = fused[:, :6]
        miss_ids = np.ascontiguousarray(fused[:, 6:6 + mc]).reshape(-1)
        next_pack = fused[:, 6 + mc:]
        staged = self._placed(
            np.asarray(self.host_stage(miss_ids)).reshape(n, mc, -1))
        return blocks, frontier, num, plan, feat_stats, staged, \
            nxt, next_pack

    def _batch(self, blocks, frontier, num, seeds_step, labels_step, nb):
        n, b = self.n_shards, seeds_step.shape[0] // self.n_shards
        return self._SampledBatch(
            seeds=self._placed(seeds_step.reshape(n, b)),
            labels=self._placed(labels_step.reshape(n, b)),
            num_seeds=nb, frontier=frontier, num_frontier=num,
            blocks=tuple(blocks))

    def run_epoch(self, state, seeds_epoch: np.ndarray,
                  labels_epoch: np.ndarray, epoch: int) -> Dict:
        """seeds_epoch/labels_epoch: (steps, n_shards*batch) int32."""
        steps = seeds_epoch.shape[0]
        n = self.n_shards
        b = seeds_epoch.shape[1] // n
        state = self._rep_put(state)
        key = jax.random.fold_in(state.rng, epoch)
        nb = self._placed(np.full((n,), b, np.int32))
        t0 = time.perf_counter()
        stats0 = dict(self.stats)
        losses, cap_overflow = [], []
        feat_stats = np.zeros(6, np.int64)
        host_feat_bytes = 0
        itemsize = np.dtype(self.fcache.np_dtype()).itemsize
        dim = self.fcache.rows.shape[1]

        k0 = self._rep_put(jax.random.fold_in(key, 0))
        carry_p = self._j_start(self.topo.hot_ids, self.topo.sub_indptr,
                                self.topo.sub_indices, k0,
                                self._placed(seeds_epoch[0].reshape(n, b)),
                                nb)
        carry, packed0 = carry_p[0], self._fetch(carry_p[1])
        for i in range(steps):
            k_i = self._rep_put(jax.random.fold_in(key, i))
            k_n = self._rep_put(jax.random.fold_in(key, (i + 1) % steps))
            seeds_next = self._placed(
                seeds_epoch[(i + 1) % steps].reshape(n, b))
            blocks, frontier, num, plan, fstats, staged, carry, packed0 \
                = self._advance(carry, packed0, k_i,
                                epoch * 1_000_003 + i, k_n, seeds_next,
                                nb)
            batch = self._batch(blocks, frontier, num, seeds_epoch[i],
                                labels_epoch[i], nb)
            state, loss, over = self.jit_train_from(
                state, self.fcache.rows, batch, plan, staged)
            # batch i+1's hop-0 host leg runs NOW, overlapping train(i)
            losses.append(loss)
            cap_overflow.append(over)
            s = fstats.sum(axis=0)
            feat_stats += s.astype(np.int64)
            host_feat_bytes += int(np.minimum(
                fstats[:, 1], self.fcache.miss_cap).sum()) * dim * itemsize
            from legion.train.train_state import maybe_checkpoint_step
            maybe_checkpoint_step(self.cfg.train, state, i)

        losses, cap_overflow = jax.device_get((losses, cap_overflow))
        dt = time.perf_counter() - t0
        # total sampled edges = last-hop blocks (feat pack col 4) +
        # earlier-hop blocks (hop pack col 1, accumulated in _cold)
        edges = int(feat_stats[4]) + (self.stats["edges"]
                                      - stats0["edges"])
        return {
            "state": state, "steps": steps, "seconds": dt,
            "first_loss": float(losses[0]) if losses else float("nan"),
            "loss": float(losses[-1]) if losses else float("nan"),
            "cap_overflow": int(sum(int(o.sum()) for o in cap_overflow)),
            "feat_hit_rate": float(feat_stats[0]) / max(float(
                feat_stats[2]), 1.0),
            "staging_overflow": int(feat_stats[3]),
            # hot rows past the exchanges' per-owner caps, served by the
            # host instead: feature rows, and topology rows over all hops
            "exchange_overflow": int(feat_stats[5]),
            "topo_exchange_overflow": (self.stats["topo_demoted"]
                                       - stats0["topo_demoted"]),
            "edges": edges,
            "edges_per_s": edges / max(dt, 1e-9),
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
        """seeds: (steps, n*b) -1-padded; counts: (steps, n)."""
        key = key if key is not None else jax.random.PRNGKey(4242)
        n = self.n_shards
        b = seeds.shape[1] // n
        steps = seeds.shape[0]
        if steps == 0:
            return float("nan")
        params = self._rep_put(params)
        a_acc = b_acc = None
        k0 = self._rep_put(jax.random.fold_in(key, 0))
        carry_p = self._j_start(
            self.topo.hot_ids, self.topo.sub_indptr, self.topo.sub_indices,
            k0, self._placed(seeds[0].reshape(n, b)),
            self._placed(counts[0].astype(np.int32)))
        carry, packed0 = carry_p[0], self._fetch(carry_p[1])
        for t in range(steps):
            k_t = self._rep_put(jax.random.fold_in(key, t))
            k_n = self._rep_put(jax.random.fold_in(key, (t + 1) % steps))
            blocks, frontier, num, plan, fstats, staged, carry, packed0 \
                = self._advance(carry, packed0, k_t, 777_000 + t, k_n,
                                self._placed(
                                    seeds[(t + 1) % steps].reshape(n, b)),
                                self._placed(
                                    counts[(t + 1) % steps]
                                    .astype(np.int32)))
            batch = self._batch(blocks, frontier, num, seeds[t], labels[t],
                                self._placed(counts[t].astype(np.int32)))
            a, bb = self.jit_eval_from(params, self.fcache.rows, batch,
                                       plan, staged)
            a = a.astype(jnp.float32)
            bb = bb.astype(jnp.float32)
            a_acc = a if a_acc is None else a_acc + a
            b_acc = bb if b_acc is None else b_acc + bb
        # LP and accuracy aggregate identically (sum / count) — see
        # train.loop.lp_logsigmoid_sum
        a_sum = float(jax.device_get(a_acc))
        return a_sum / max(float(jax.device_get(b_acc)), 1.0)
