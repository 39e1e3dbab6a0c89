#!/usr/bin/env python
"""Smoke run of the training main path on an NVIDIA GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --cards 4  # the multi-card paths, on four cards

One card, in one process:

1. device: the GPU, its name and power limit (``nvidia-smi``), the JAX
   version and the native host runtime, which must load;
2. parity at real widths against the plain references: sampled neighbour
   ids of the lined, aligned and windowed layouts against the per-edge
   sampler (exact; ids up to 2.4M and above 2^24), dedup/renumbering
   against ``np.unique`` (exact), layer-1 and layer-2 aggregation against
   a float64 numpy oracle, one SAGE and one GCN layer (forward and
   parameter gradients) against ``tests/oracle.py`` at hidden 256;
3. the main path: ``train.main`` trains GraphSAGE, GCN, the hotness-cache
   path (host features) and the host-topology hybrid for one epoch each
   on a products-shaped graph (2,449,029 nodes, average degree 50,
   100-dim features, 47 classes) at the flagship width — hidden 256,
   fanout [25,10], batch 8000, bf16 compute with f32 params — with a
   checkpoint saved and restored. Each run must give a finite loss that
   falls, zero frontier-cap overflow and a bit-exact restore.

``--cards 4`` runs only the multi-card paths, on four cards of one host,
each through ``train.main``: data-parallel training (mesh data=4,
cache=1), the striped cache (data=2, cache=2) and the striped hybrid
(data=1, cache=4). First, in f32, a one-step epoch of each is
recomputed on one card from the same seeds and sampled batches: the
loss and the updated parameters must agree within the printed
tolerance. Then each trains a short bf16 epoch at the flagship width
and batch 8000 per card on the products-shaped graph: finite, falling
loss. Throughout, hit rates lie in (0, 1], nothing is demoted or
dropped, and every card holds its share of the work.

Any failed check ends the run with a non-zero exit, and so does a
machine where JAX finds no GPU. The last line of stdout is one JSON
object, ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from legion import runtime  # noqa: E402
from legion.config import (CacheConfig, Config, DatasetConfig,  # noqa: E402
                           ModelConfig, ParallelConfig, SamplerConfig,
                           TrainConfig)
from legion.data.format import GraphData, pad_feature_dim, save_dataset  # noqa: E402
from legion.data.synthetic import bench_graph  # noqa: E402
from legion.models.gcn import graph_conv, graph_conv_init  # noqa: E402
from legion.models.sage import sage_conv, sage_conv_init  # noqa: E402
from legion.ops.segment import fanout_gather_mean, fanout_gather_sum  # noqa: E402
from legion.sampling.block import Block, frontier_caps  # noqa: E402
from legion.sampling.sampler import (DeviceGraph, gather_features,  # noqa: E402
                                     grow_frontier, sample_batch,
                                     sample_neighbors,
                                     sample_neighbors_per_edge)
from legion.train.loop import masked_softmax_ce  # noqa: E402
from legion.train.train_state import restore_checkpoint  # noqa: E402
from legion.utils.compile_cache import configure_compile_cache  # noqa: E402
from tests.oracle import (decode_block, gcn_conv_grads_np,  # noqa: E402
                          gcn_conv_np, sage_conv_grads_np, sage_conv_np)

# The flagship: GraphSAGE on products (config.py DATASET_REGISTRY["PR"]).
HIDDEN, FANOUTS, BATCH, CLASSES = 256, (25, 10), 8000, 47
WORK = os.path.join(ROOT, ".smoke_data")


class CheckFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise CheckFailed(msg)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| (float64)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def require_gpu(cards: int):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs an NVIDIA GPU: JAX found no GPU "
                 f"(platform {devs[0].platform!r}, {devs[0].device_kind})")
    if len(devs) < cards:
        sys.exit(f"chip_smoke.py --cards {cards} needs {cards} GPUs; JAX "
                 f"found {len(devs)}")
    return devs


def device_phase(devs) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for i, line in enumerate(smi):
        print(f"card {i}: {line}")
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    native = runtime.native_available()
    print(f"native host runtime loaded: {native}")
    check(native, "the native host runtime (legion/runtime/gnnio.cpp) "
                  "did not build or load")


# ---------------------------------------------------------------------------
# 2. parity at real widths
# ---------------------------------------------------------------------------

def high_id_graph(num_nodes: int, rows: int, seed: int):
    """CSR over ``num_nodes`` ids in which ``rows`` nodes have edges (half
    of them, and half of all neighbour ids, at or above 2^24 when the id
    space reaches it); 2% of the rows have 150-400 neighbours so the
    long-run paths of every layout are exercised."""
    rng = np.random.default_rng(seed)
    top = min(1 << 24, num_nodes // 2)
    src_rows = np.unique(np.concatenate([
        rng.integers(0, top, rows // 2), rng.integers(top, num_nodes,
                                                      rows // 2)]))
    deg = rng.integers(20, 65, src_rows.shape[0])
    big = rng.random(src_rows.shape[0]) < 0.02
    deg[big] = rng.integers(150, 401, int(big.sum()))
    counts = np.zeros(num_nodes, np.int64)
    counts[src_rows] = deg
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    e = int(indptr[-1])
    indices = np.where(rng.random(e) < 0.5,
                       rng.integers(top, num_nodes, e),
                       rng.integers(0, num_nodes, e)).astype(np.int32)
    return indptr, indices, src_rows.astype(np.int32)


def check_sampler_ids(indptr, indices, candidates, layouts, frontier_size,
                      fanout: int, seed: int, label: str) -> None:
    """The windowed/aligned/lined samplers must draw exactly the ids of
    the per-edge sampler (bit-identical draws by construction)."""
    rng = np.random.default_rng(seed)
    frontier = np.full(frontier_size, -1, np.int32)
    take = min(frontier_size - 8, candidates.shape[0])
    frontier[:take] = rng.choice(candidates, take, replace=False)
    frontier = jnp.asarray(frontier)
    key = jax.random.PRNGKey(seed)
    for layout in layouts:
        g = DeviceGraph.from_host(indptr, indices, layout=layout)
        check({"lined": g.lined, "aligned": g.astart is not None,
               "windowed": not g.lined and g.astart is None}[layout],
              f"{label}: from_host did not build the {layout} layout")
        got = np.asarray(jax.jit(sample_neighbors, static_argnums=3)(
            key, g, frontier, fanout))
        want = np.asarray(jax.jit(sample_neighbors_per_edge,
                                  static_argnums=3)(key, g, frontier,
                                                    fanout))
        bad = int((got != want).sum())
        print(f"sampler ids [{label}, {layout}]: P={frontier_size} "
              f"f={fanout}, max id {int(want.max())}, ids >= 2^11: "
              f"{int((want >= 1 << 11).sum())}, ids >= 2^24: "
              f"{int((want >= 1 << 24).sum())}, mismatches {bad} "
              "(exact equality required)")
        check(bad == 0, f"{label} {layout}: {bad} sampled ids differ from "
                        "the per-edge sampler")
        del g


def dedup_reference(prev: np.ndarray, num_prev: int, nbrs: np.ndarray):
    """np.unique reference of grow_frontier: the previous frontier keeps
    its prefix, new ids follow in sorted order, nbr_pos indexes the new
    frontier."""
    old = prev[:num_prev]
    new = np.setdiff1d(np.unique(nbrs[nbrs >= 0]), old)
    frontier = np.concatenate([old, new])
    order = np.argsort(frontier)
    pos = order[np.searchsorted(frontier[order], np.where(nbrs >= 0, nbrs,
                                                          frontier[0]))]
    return frontier, np.where(nbrs >= 0, pos, 0)


def check_dedup(graph: DeviceGraph, seeds: np.ndarray, fanouts,
                seed: int) -> None:
    b = seeds.shape[0]
    caps = frontier_caps(b, fanouts)
    frontier = jnp.asarray(seeds.astype(np.int32))
    num = jnp.asarray(b, jnp.int32)
    key = jax.random.PRNGKey(seed)
    grow = jax.jit(grow_frontier, static_argnums=3)
    for k, f in enumerate(fanouts):
        key, sub = jax.random.split(key)
        nbrs = jax.jit(sample_neighbors, static_argnums=3)(
            sub, graph, frontier, f)
        new, num_new, blk = grow(frontier, num, nbrs, caps[k + 1])
        want_f, want_pos = dedup_reference(np.asarray(frontier), int(num),
                                           np.asarray(nbrs))
        n = int(num_new)
        ok = (n == want_f.shape[0]
              and np.array_equal(np.asarray(new)[:n], want_f)
              and bool((np.asarray(new)[n:] == -1).all())
              and np.array_equal(np.asarray(blk.nbr_pos), want_pos))
        print(f"dedup hop {k + 1}: {int(num)} x {f} draws -> {n} "
              f"frontier ids (cap {caps[k + 1]}), equal to np.unique "
              f"reference: {ok}")
        check(ok, f"dedup hop {k + 1} differs from the np.unique reference")
        frontier, num = new, num_new


def agg_oracle(rows: np.ndarray, mask: np.ndarray, norm: str):
    m = mask.astype(np.float64)[..., None]
    s = (rows.astype(np.float64) * m).sum(1)
    cnt = np.maximum(mask.sum(1), 1).astype(np.float64)[:, None]
    return {"mean": s / cnt, "sum": s, "sqrt": s / np.sqrt(cnt)}[norm]


def check_aggregation(p_id: int, f_id: int, p_g: int, f_g: int, src_g: int,
                      d: int, seed: int) -> None:
    """Layer-1 (identity block) and layer-2 (gathered block) masked
    aggregation against a float64 numpy oracle: f32 within 1e-5, bf16
    within 2e-2 (max error over max |oracle|)."""
    rng = np.random.default_rng(seed)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}
    # identity block: dst d reads rows off + d*f .. off + d*f + f - 1
    off = p_id
    x = rng.standard_normal((off + p_id * f_id, d)).astype(np.float32)
    mask = rng.random((p_id, f_id)) < 0.9
    mask[::97] = False                                  # zero in-degree
    blk = Block(nbr_pos=jnp.zeros((p_id, f_id), jnp.int32),
                nbr_mask=jnp.asarray(mask), num_src=jnp.int32(0),
                num_dst=jnp.int32(p_id), identity_offset=off)
    rows = x[off:].reshape(p_id, f_id, d)
    # gathered block: random positions into src_g rows
    h = rng.standard_normal((src_g, d)).astype(np.float32)
    pos = rng.integers(0, src_g, (p_g, f_g)).astype(np.int32)
    gmask = rng.random((p_g, f_g)) < 0.9
    gblk = Block(nbr_pos=jnp.asarray(pos), nbr_mask=jnp.asarray(gmask),
                 num_src=jnp.int32(src_g), num_dst=jnp.int32(p_g))
    fns = {"mean": fanout_gather_mean, "sum": fanout_gather_sum}
    for dt in ("float32", "bfloat16"):
        xd, hd = jnp.asarray(x, dt), jnp.asarray(h, dt)
        rows_in = np.asarray(xd.astype(jnp.float32))[off:].reshape(
            p_id, f_id, d) if dt == "bfloat16" else rows
        hin = np.asarray(hd.astype(jnp.float32))
        for norm, fn in fns.items():
            got = jax.jit(fn)(xd, blk)
            e1 = rel_err(got, agg_oracle(rows_in, mask, norm))
            got2 = jax.jit(fn)(hd, gblk)
            e2 = rel_err(got2, agg_oracle(hin[pos], gmask, norm))
            print(f"aggregation {norm} {dt}: identity P={p_id} f={f_id} "
                  f"D={d} rel err {e1:.2e}; gathered P={p_g} f={f_g} "
                  f"D={d} rel err {e2:.2e} (tolerance {tol[dt]:.0e})")
            check(e1 <= tol[dt] and e2 <= tol[dt],
                  f"aggregation {norm} {dt} beyond tolerance")


def check_models(graph: DeviceGraph, features: np.ndarray,
                 seeds: np.ndarray, hidden: int, classes: int,
                 seed: int) -> None:
    """One SAGE and one GCN layer of each block kind (layer 1: identity
    block, features -> hidden; layer 2: gathered block, hidden ->
    classes): forward and parameter gradients of sum(out * r) against
    tests/oracle.py in float64. f32 runs at matmul precision "highest"
    (tolerance 1e-4); bf16 compute is held to 5e-2 (max error over max
    |oracle|)."""
    b = seeds.shape[0]
    caps = frontier_caps(b, FANOUTS)
    batch = jax.jit(sample_batch, static_argnums=(5, 6, 7))(
        jax.random.PRNGKey(seed), graph, jnp.asarray(seeds),
        jnp.asarray(b, jnp.int32), jnp.zeros((b,), jnp.int32), FANOUTS,
        caps, False)
    feats = jnp.asarray(pad_feature_dim(np.asarray(features, np.float32)))
    x = np.asarray(gather_features(feats, batch.frontier))
    rng = np.random.default_rng(seed)
    layers = [(batch.blocks[-1], x, hidden),
              (batch.blocks[0],
               rng.standard_normal((caps[1], hidden)).astype(np.float32),
               classes)]
    tol = {"float32": 1e-4, "bfloat16": 5e-2}
    for li, (blk, h_src, out_dim) in enumerate(layers):
        edges, _, _ = decode_block(batch, blk)
        r = rng.standard_normal((blk.dst_cap, out_dim)).astype(np.float32)
        ps = sage_conv_init(jax.random.PRNGKey(li), h_src.shape[1], out_dim)
        pg = graph_conv_init(jax.random.PRNGKey(li), h_src.shape[1],
                             out_dim)
        h64, r64 = h_src.astype(np.float64), r.astype(np.float64)
        to64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        p64, g64 = to64(ps), to64(pg)
        refs = {
            "sage": (sage_conv_np(h64, edges, blk.dst_cap,
                                  p64["fc_self"]["kernel"],
                                  p64["fc_self"]["bias"],
                                  p64["fc_neigh"]["kernel"]),
                     sage_conv_grads_np(h64, edges, blk.dst_cap, r64)),
            "gcn": (gcn_conv_np(h64, edges, h_src.shape[0], blk.dst_cap,
                                g64["dense"]["kernel"], g64["bias"]),
                    gcn_conv_grads_np(h64, edges, h_src.shape[0],
                                      blk.dst_cap, r64)),
        }
        for dt in ("float32", "bfloat16"):
            for arch, conv, p in (("sage", sage_conv, ps),
                                  ("gcn", graph_conv, pg)):
                # h and r are arguments: as closure constants XLA would
                # constant-fold the weight-gradient matmuls at compile
                def loss(p, h, r, conv=conv, dt=dt):
                    out = conv(p, blk, h, jnp.dtype(dt))
                    return jnp.sum(out.astype(jnp.float32) * r), out
                prec = "highest" if dt == "float32" else None
                with jax.default_matmul_precision(prec):
                    (_, out), grads = jax.jit(jax.value_and_grad(
                        loss, has_aux=True))(p, jnp.asarray(h_src),
                                             jnp.asarray(r))
                ref_out, ref_grads = refs[arch]
                ef = rel_err(out, ref_out)
                eg = max(rel_err(a, b_) for a, b_ in zip(
                    jax.tree.leaves(grads), jax.tree.leaves(ref_grads)))
                print(f"model {arch} layer {li + 1} {dt}: "
                      f"{h_src.shape[1]}->{out_dim}, dst {blk.dst_cap} x "
                      f"f{blk.fanout}: forward rel err {ef:.2e}, grad rel "
                      f"err {eg:.2e} (tolerance {tol[dt]:.0e})")
                check(ef <= tol[dt] and eg <= tol[dt],
                      f"{arch} layer {li + 1} {dt} beyond tolerance")


def parity_phase(data: GraphData, width: int = 141_952,
                 high_ids: int = (1 << 24) + (1 << 20),
                 high_rows: int = 400_000, batch: int = BATCH,
                 model_batch: int = 1024, hidden: int = HIDDEN,
                 seed: int = 0) -> None:
    """Defaults are the real widths: ``width`` is the flagship's hop-2
    frontier cap, ``batch`` its seed batch, 128 its padded feature
    width."""
    indptr = np.asarray(data.indptr)
    indices = np.asarray(data.indices)
    has_edges = np.flatnonzero(np.diff(indptr) > 0).astype(np.int32)
    check_sampler_ids(indptr, indices, has_edges,
                      ("lined", "aligned", "windowed"), width, FANOUTS[1],
                      seed, "products")
    hi_indptr, hi_indices, hi_rows = high_id_graph(high_ids, high_rows,
                                                   seed)
    check_sampler_ids(hi_indptr, hi_indices, hi_rows,
                      ("aligned", "windowed"), width, FANOUTS[1], seed,
                      f"{high_ids} ids")
    del hi_indptr, hi_indices, hi_rows
    g = DeviceGraph.from_host(indptr, indices)
    rng = np.random.default_rng(seed)
    seeds = rng.choice(np.asarray(data.train_ids), batch, replace=False)
    check_dedup(g, seeds.astype(np.int32), FANOUTS, seed)
    check_aggregation(width, FANOUTS[1], batch, FANOUTS[0], width, 128,
                      seed)
    check_models(g, np.asarray(data.features),
                 seeds[:model_batch].astype(np.int32), hidden, CLASSES,
                 seed)
    print(f"parity: all checks passed ({data.num_nodes} nodes)")


# ---------------------------------------------------------------------------
# 3. main-path runs through train.main
# ---------------------------------------------------------------------------

class StepRecorder:
    """While a run builds its trainers, wraps ``jax.jit`` so the train
    step (the jitted function named in ``names``) remembers its first
    call: abstract argument shapes (for ``memory_analysis``) and, with
    ``keep=True``, the arguments themselves with a copy of the state
    before the step and the step's output."""

    def __init__(self, names=("epoch_scan", "train_from"), keep=False):
        self.names, self.keep = names, keep
        self.fn = self.abstract = self.args = self.state0 = self.out = None

    def __enter__(self):
        self._jit = jax.jit
        rec = self

        def jit(fun, *a, **k):
            j = rec._jit(fun, *a, **k)
            if getattr(fun, "__name__", None) not in rec.names:
                return j

            def call(*args):
                first = rec.fn is None
                if first:
                    rec.fn = j
                    rec.abstract = jax.tree.map(
                        lambda x: jax.ShapeDtypeStruct(
                            x.shape, x.dtype, sharding=x.sharding)
                        if isinstance(x, jax.Array) else x, args)
                    if rec.keep:
                        rec.state0 = jax.tree.map(jnp.copy, args[0])
                        rec.args = args[1:]
                out = j(*args)
                if first and rec.keep:   # the next step donates `out`
                    rec.out = jax.tree.map(jnp.copy, out)
                return out
            return call

        jax.jit = jit
        return self

    def __exit__(self, *exc):
        jax.jit = self._jit
        return False

    def memory_analysis(self):
        return self.fn.lower(*self.abstract).compile().memory_analysis()


def smoke_dataset(path: str, num_nodes: int, avg_degree: int,
                  eval_nodes: int, seed: int,
                  train_per_card: int = 0) -> GraphData:
    """Products-shaped graph (data.synthetic.bench_graph) with labels a
    GNN can learn — the argmax of a random projection of each node's own
    features — and eval splits of ``eval_nodes`` each; saved in the
    packed layout ``train.py --config`` loads. ``train_per_card`` > 0
    cuts the train split to that many ids in each of the four shards
    the mesh drivers deal (id % 4), so an epoch at batch b has
    (train_per_card - 1) // b steps."""
    g = bench_graph(num_nodes=num_nodes, avg_degree=avg_degree,
                    feature_dim=100, num_classes=CLASSES, seed=seed)
    w = np.random.default_rng(seed + 1).standard_normal(
        (g.features.shape[1], CLASSES)).astype(np.float32)
    g.labels = (g.features @ w).argmax(1).astype(np.int32)
    g.valid_ids = g.valid_ids[:eval_nodes]
    g.test_ids = g.test_ids[:eval_nodes]
    if train_per_card:
        parts = [g.train_ids[g.train_ids % 4 == r][:train_per_card]
                 for r in range(4)]
        check(all(len(p) == train_per_card for p in parts),
              f"train split too small for {train_per_card} ids per card")
        g.train_ids = np.sort(np.concatenate(parts))
    shutil.rmtree(path, ignore_errors=True)
    save_dataset(g, path)
    return g


def run_config(data_dir: str, ckpt: str, arch: str, cache_gb: float,
               topology: str, batch: int, hidden: int, devices: int = 1,
               group: int = 1, dtype: str = "bfloat16",
               dropout: float = 0.5, lr: float = 0.003) -> Config:
    return Config(
        dataset=DatasetConfig(name="products-shaped", path=data_dir,
                              num_classes=CLASSES,
                              feature_placement=("host" if cache_gb
                                                 else "hbm"),
                              topology_placement=topology),
        sampler=SamplerConfig(fanouts=FANOUTS, batch_size=batch),
        model=ModelConfig(arch=arch, hidden_dim=hidden,
                          num_layers=len(FANOUTS), dropout=dropout,
                          dtype=dtype),
        train=TrainConfig(learning_rate=lr, epochs=1, seed=0,
                          checkpoint_dir=ckpt),
        cache=CacheConfig(enabled=cache_gb > 0,
                          budget_bytes=int(cache_gb * 2 ** 30),
                          group_size=group),
        parallel=ParallelConfig(num_devices=devices))


def train_main(cfg: Config, name: str, work: str):
    import train
    path = os.path.join(work, f"{name}.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return train.main(["--config", path])


MAIN_RUNS = {                   # name: (arch, cache GiB, topology)
    "sage": ("sage", 0.0, "hbm"),
    "gcn": ("gcn", 0.0, "hbm"),
    "cached": ("sage", 0.25, "hbm"),
    "hybrid": ("sage", 0.5, "host"),
}


def main_path_run(name: str, data_dir: str, work: str, arch: str,
                  cache_gb: float, topology: str, batch: int = BATCH,
                  hidden: int = HIDDEN, lr: float = 0.003,
                  devices: int = 1, group: int = 1) -> dict:
    """One bf16 epoch through ``train.main`` with a checkpoint saved and
    restored: finite, falling loss, no cap or staging overflow, no
    demotion (multi-card cached paths must record it), hit rate in
    (0, 1], bit-exact restore."""
    ckpt = os.path.join(work, "ckpt_" + re.sub(r"\W+", "_", name))
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = run_config(data_dir, ckpt, arch, cache_gb, topology, batch,
                     hidden, devices=devices, group=group, lr=lr)
    compile_s = 0.0

    def on_event(event, duration, **_):
        nonlocal compile_s
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)
    t0 = time.perf_counter()
    try:
        with StepRecorder() as rec:
            res = train_main(cfg, name, work)
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    wall = time.perf_counter() - t0
    h = res["history"][0]
    state = res["trainer"].state if "trainer" in res and hasattr(
        res["trainer"], "state") else res["state"]
    restored = restore_checkpoint(ckpt, state)
    exact = restored is not None and all(
        np.array_equal(np.asarray(a), np.asarray(b)) and a.dtype == b.dtype
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)))
    hit = h.get("cache_hit_rate", h.get("feat_hit_rate"))
    # demoted: hot rows past an exchange's per-owner cap, served from
    # the host instead (multi-card cached paths only)
    demoted = {k: h[k] for k in ("exchange_overflow",
                                 "topo_exchange_overflow") if k in h}
    out = {"run": name, "arch": arch, "compile_s": compile_s,
           "wall_s": wall, "steps": h["steps"],
           "first_loss": h["first_loss"], "last_loss": h["loss"],
           "cap_overflow": h["cap_overflow"],
           "staging_overflow": h.get("staging_overflow", 0),
           "demoted": demoted, "hit_rate": hit,
           # the process's peak so far (JAX keeps no per-run peak)
           "peak_bytes_in_use": [(d.memory_stats() or {}).get(
               "peak_bytes_in_use") for d in jax.devices()[:devices]],
           "checkpoint_restored_exact": exact}
    print(f"main path [{name}]: " + json.dumps(out))
    print(f"main path [{name}] train step memory_analysis: "
          f"{rec.memory_analysis()}")
    check(np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"]),
          f"{name}: non-finite loss")
    check(out["last_loss"] < out["first_loss"],
          f"{name}: loss did not fall ({out['first_loss']} -> "
          f"{out['last_loss']})")
    check(out["cap_overflow"] == 0 and out["staging_overflow"] == 0,
          f"{name}: cap overflow {out['cap_overflow']}, staging overflow "
          f"{out['staging_overflow']}")
    check_demotions(name, devices, cache_gb, topology, demoted)
    check(hit is None or 0.0 < hit <= 1.0, f"{name}: hit rate {hit}")
    check(exact, f"{name}: checkpoint restore is not bit-exact")
    if devices > 1:
        spread_check(name, per_card_args(rec.abstract[1:], cache_gb))
    return out


def check_demotions(name: str, devices: int, cache_gb: float,
                    topology: str, demoted: dict) -> None:
    """Zero demotions, and a multi-card cached run must have counted
    them: feature rows, and with host topology also hot hops."""
    need = (() if devices == 1 or not cache_gb else
            ("exchange_overflow",) + (("topo_exchange_overflow",)
                                      if topology == "host" else ()))
    check(all(k in demoted for k in need),
          f"{name}: the trainer recorded no demotion count ({need})")
    check(not any(demoted.values()), f"{name}: demoted {demoted}")


# ---------------------------------------------------------------------------
# 4. multi-card paths (--cards 4)
# ---------------------------------------------------------------------------

# The multi-card checks train in f32 at full matmul precision on both
# sides: under the GPU's default an f32 dot may run in TF32, and two
# programs may round differently, which would hide a wrong step.
F32_PRECISION = "highest"


def reference_step(state0, model, batches, feats):
    """One card: mean loss and Adam-updated state over per-card batches
    whose features come straight from the full table."""
    losses, acc = [], None
    for bc in batches:
        def lf(p, bc=bc):
            x = gather_features(feats, bc.frontier)
            out = model.apply({"params": p}, tuple(reversed(bc.blocks)), x,
                              deterministic=True)[: bc.seed_cap]
            return masked_softmax_ce(out, bc.labels, bc.seed_mask())
        loss, g = jax.value_and_grad(lf)(state0.params)
        losses.append(float(loss))
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
    gmean = jax.tree.map(lambda a: a / len(batches), acc)
    return float(np.mean(losses)), state0.apply_gradients(gmean)


def compare_step(name: str, loss, ref_loss, state, ref_state,
                 lr: float) -> None:
    """Loss within 1e-4 relative; the gradient (Adam's first moment after
    one step is 0.1 x grad) within 1e-3 of each leaf's largest entry
    (sums in another order, scatter-add atomics); the updated params
    within 5% of one Adam step (lr): where |grad| is near Adam's eps the
    step's size follows the last bits of the gradient."""
    le = abs(float(loss) - ref_loss) / max(abs(ref_loss), 1e-30)
    ge = max(rel_err(a, b) for a, b in zip(
        jax.tree.leaves(state.opt_state[0].mu),
        jax.tree.leaves(ref_state.opt_state[0].mu)))
    pe = max(float(np.abs(np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)).max())
             for a, b in zip(jax.tree.leaves(state.params),
                             jax.tree.leaves(ref_state.params)))
    print(f"{name}: first-step loss {float(loss):.6f} vs one-card "
          f"{ref_loss:.6f} (rel {le:.2e}, tolerance 1e-04); gradient rel "
          f"err {ge:.2e} (tolerance 1e-03); updated params max |diff| "
          f"{pe:.2e} (tolerance {0.05 * lr:.1e} = 5% of lr {lr})")
    check(le <= 1e-4 and ge <= 1e-3 and pe <= 0.05 * lr,
          f"{name}: differs from one card")


def per_card_args(args, cache_gb: float):
    """The per-card inputs of a recorded mesh train step: the seeds and
    labels of the DP epoch (graph and features are replicated), the
    sampled batch of the striped trainers' train step."""
    return args[2:] if not cache_gb else args[1]


def spread_check(name: str, arrays) -> None:
    """Every card allocated memory (peak bytes in use, where the backend
    reports it), and every per-card array of the step (arrays or their
    recorded shapes and shardings) is split over the four cards, each
    holding a quarter."""
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:4]]
    leaves = [a for a in jax.tree.leaves(arrays)
              if isinstance(a, (jax.Array, jax.ShapeDtypeStruct))]
    split = [len(a.sharding.device_set) == 4
             and 4 * np.prod(a.sharding.shard_shape(a.shape)) == np.prod(
                 a.shape) for a in leaves]
    print(f"{name}: peak bytes in use per card {peaks}; {sum(split)} of "
          f"{len(leaves)} per-card arrays split a quarter per card")
    check(all(p is None or p > 0 for p in peaks) and leaves and all(split),
          f"{name}: work is not spread over four cards")


def f32_run(name: str, data_dir: str, work: str, cache_gb: float,
            topology: str, group: int, batch: int, hidden: int):
    """train.main in f32 without dropout at matmul precision "highest",
    its train step recorded: (recorder, history record)."""
    ckpt = os.path.join(work, "ckpt_f32")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = run_config(data_dir, ckpt, "sage", cache_gb, topology, batch,
                     hidden, devices=4, group=group, dtype="float32",
                     dropout=0.0)
    names = ("train_from",) if cache_gb else ("epoch_scan",)
    with (StepRecorder(names=names, keep=True) as rec,
          jax.default_matmul_precision(F32_PRECISION)):
        res = train_main(cfg, name, work)
    return rec, res, cfg.train.learning_rate


def dp_phase(data_dir: str, work: str, batch: int, hidden: int) -> None:
    """The MeshTrainer path (train.py --devices 4) on a one-step train
    split, against one card running each card's batch from the seeds
    and labels the trainer sharded."""
    from legion.models import build_model
    name = "dp (data=4, cache=1)"
    rec, res, lr = f32_run(name, data_dir, work, 0.0, "hbm", 1, batch,
                           hidden)
    h = res["history"][0]
    print(f"{name}: {h['steps']} step, loss {h['loss']:.6f}, cap "
          f"overflow {h['cap_overflow']}")
    check(h["steps"] == 1, f"{name}: {h['steps']} steps, not 1")
    check(h["cap_overflow"] == 0, f"{name}: cap overflow "
                                  f"{h['cap_overflow']}")
    spread_check(name, per_card_args(rec.args, 0.0))
    state_after, losses, _ = rec.out
    dev = jax.devices()[0]
    state0, graph, feats = jax.device_put(
        (rec.state0, rec.args[0], rec.args[1]), dev)
    seeds, labels = (np.asarray(a)[0] for a in rec.args[2:])
    caps = res["trainer"].caps
    model = build_model("sage", hidden, CLASSES, 2, 0.0, dtype="float32")
    base = jax.random.fold_in(state0.rng, state0.step)
    batches = []
    for c in range(4):
        skey, _ = jax.random.split(jax.random.fold_in(base, jnp.int32(c)))
        sl = slice(c * batch, (c + 1) * batch)
        batches.append(jax.jit(sample_batch, static_argnums=(5, 6, 7))(
            skey, graph, jnp.asarray(seeds[sl]),
            jnp.asarray(batch, jnp.int32), jnp.asarray(labels[sl]),
            FANOUTS, caps, res["trainer"].cfg.sampler.dedup_last))
    with jax.default_matmul_precision(F32_PRECISION):
        ref_loss, ref = reference_step(state0, model, batches, feats)
    compare_step(name, losses[0], ref_loss, state_after, ref, lr)


def striped_phase(name: str, data_dir: str, data: GraphData, work: str,
                  topology: str, group: int, batch: int, hidden: int,
                  cache_gb: float) -> None:
    """The first train step of a striped driver, against one card
    running each card's recorded batch on the full feature table."""
    from legion.models import build_model
    rec, res, lr = f32_run(name, data_dir, work, cache_gb, topology, group,
                           batch, hidden)
    h = res["history"][0]
    hit = h.get("cache_hit_rate", h.get("feat_hit_rate"))
    demoted = {k: h[k] for k in ("exchange_overflow",
                                 "topo_exchange_overflow") if k in h}
    print(f"{name}: epoch loss {h['loss']:.4f}, hit rate {hit}, staging "
          f"overflow {h['staging_overflow']}, cap overflow "
          f"{h['cap_overflow']}, demoted {demoted}")
    check(0.0 < hit <= 1.0, f"{name}: hit rate {hit}")
    check(h["staging_overflow"] == 0 and h["cap_overflow"] == 0,
          f"{name}: staging overflow {h['staging_overflow']}, cap "
          f"overflow {h['cap_overflow']}")
    check_demotions(name, 4, cache_gb, topology, demoted)
    batch_arr = per_card_args(rec.args, cache_gb)
    spread_check(name, batch_arr)
    state_after, loss, _ = rec.out
    model = build_model("sage", hidden, CLASSES, 2, 0.0, dtype="float32")
    state0 = jax.device_put(rec.state0, jax.devices()[0])
    host = jax.device_get(batch_arr)
    batches = [jax.device_put(jax.tree.map(lambda a: a[c], host),
                              jax.devices()[0]) for c in range(4)]
    # the cached paths keep features at their own width (no padding)
    feats = jax.device_put(np.asarray(data.features, np.float32),
                           jax.devices()[0])
    with jax.default_matmul_precision(F32_PRECISION):
        ref_loss, ref = reference_step(state0, model, batches, feats)
    compare_step(name, loss, ref_loss, state_after, ref, lr)


MESH_RUNS = {                   # name: (cache group Kg, topology)
    "dp (data=4, cache=1)": (1, "hbm"),
    "striped cache (data=2, cache=2)": (2, "hbm"),
    "striped hybrid (data=1, cache=4)": (4, "host"),
}


def four_card_phase(work: str, num_nodes: int = 200_000,
                    batch: int = 1024, hidden: int = HIDDEN,
                    flagship_nodes: int = 2_449_029,
                    flagship_degree: int = 50,
                    flagship_batch: int = BATCH,
                    flagship_steps: int = 4, lr: float = 0.003) -> None:
    """f32 one-step agreement with one card on a ``num_nodes`` graph
    (batch ``batch`` per card), then a bf16 epoch of ``flagship_steps``
    steps per mesh at the flagship width on a products-shaped graph
    (batch ``flagship_batch`` per card). Each cache group's budget is a
    quarter of the feature table (f32 bytes), so both hits and
    host-staged misses occur."""
    data_dir = os.path.join(work, "four_card")
    data = smoke_dataset(data_dir, num_nodes, 15, 2048, seed=5,
                         train_per_card=batch + batch // 2)
    cache_gb = data.features.nbytes / 4 / 2 ** 30
    dp_phase(data_dir, work, batch, hidden)
    for name, (group, topology) in list(MESH_RUNS.items())[1:]:
        striped_phase(name, data_dir, data, work, topology, group, batch,
                      hidden, cache_gb / group)
    del data
    tg = time.perf_counter()
    flag_dir = os.path.join(work, "four_card_flagship")
    data = smoke_dataset(flag_dir, flagship_nodes, flagship_degree, 2048,
                         seed=0, train_per_card=(flagship_steps * flagship_batch
                                                 + flagship_batch // 2))
    cache_gb = data.features.nbytes / 4 / 2 ** 30
    print(f"products-shaped graph: {data.num_nodes} nodes, "
          f"{data.num_edges} edges, made in "
          f"{time.perf_counter() - tg:.1f}s")
    del data
    for name, (group, topology) in MESH_RUNS.items():
        main_path_run(f"{name} bf16", flag_dir, work, "sage",
                      cache_gb / group if group > 1 else 0.0, topology,
                      batch=flagship_batch, hidden=hidden, lr=lr,
                      devices=4, group=group)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card paths on four cards")
    args = ap.parse_args(argv)
    devs = require_gpu(args.cards)
    configure_compile_cache()
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    device_phase(devs)
    if args.cards == 4:
        four_card_phase(WORK)
    else:
        data_dir = os.path.join(WORK, "products")
        tg = time.perf_counter()
        data = smoke_dataset(data_dir, 2_449_029, 50, 8192, seed=0)
        print(f"products-shaped graph: {data.num_nodes} nodes, "
              f"{data.num_edges} edges, made in "
              f"{time.perf_counter() - tg:.1f}s")
        parity_phase(data)
        del data
        for name, spec in MAIN_RUNS.items():
            main_path_run(name, data_dir, WORK, *spec)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
