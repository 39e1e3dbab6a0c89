"""Edge-partitioned multi-host training lifecycle.

The flagship beyond-reference configuration (SURVEY.md §7 step 7 /
BASELINE config #5): no host holds the whole graph or feature table.
Each host loads only its partition's CSR rows + feature rows
(parallel.launch per-process loading), every hop's remote neighbor
expansion and the halo feature fetch ride mesh collectives
(parallel.multihost), gradients pmean across hosts, and the lifecycle
(epochs, per-epoch valid, final test, checkpoint/resume) matches the
reference's mode schedule (``src/CUDA_IPC_Service.cu:246-259``,
``legion_graphsage.py:149-181``). Launch: one process per host with
LEGION_COORDINATOR/NUM_PROCESSES/PROCESS_ID set (parallel.launch);
degrades to the single-process (virtual) mesh for CI.
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legion.config import Config
from legion.data.format import GraphData
from legion.data.partition import edge_cut_fraction, partition_graph
from legion.models import build_model
from legion.parallel.launch import (
    maybe_initialize_distributed, put_shards_distributed)
from legion.parallel.multihost import (
    AXIS, make_partitioned_epoch_fns, owner_table, probe_dist_caps,
    probe_dist_caps_batches)
from legion.sampling.block import Block, frontier_caps
from legion.sampling.seeds import (
    interleave_shards,
    epoch_eval_seeds, epoch_train_seeds, make_seed_plan, shard_node_set)
from legion.train.train_state import (
    create_train_state, restore_checkpoint, save_checkpoint)




def _dummy_blocks(caps, fanouts):
    """Shape-only blocks for parameter init — no graph data needed, so
    a multi-process launch can init params before any shard exchange."""
    blocks = []
    for k, f in enumerate(fanouts):
        d = caps[k]
        blocks.append(Block(
            nbr_pos=jnp.zeros((d, f), jnp.int32),
            nbr_mask=jnp.zeros((d, f), bool),
            num_src=jnp.full((), caps[k + 1], jnp.int32),
            num_dst=jnp.full((), d, jnp.int32)))
    return tuple(blocks)


def run_partitioned_training(cfg: Config, data: GraphData, mesh=None,
                             log=print) -> Dict:
    nproc, pid = maybe_initialize_distributed()
    if mesh is None:
        devs = jax.devices()
        # In a real multi-process launch the mesh must span ALL global
        # devices (each process contributes its own); num_devices only
        # narrows the mesh on a single process (CI virtual mesh). The
        # default num_devices=1 means "use everything" here — slicing a
        # 4-process mesh to [:1] would leave processes 1..3 owning no
        # partition and crash their shard loading.
        if nproc == 1 and cfg.parallel.num_devices > 1:
            devs = devs[: cfg.parallel.num_devices]
        mesh = Mesh(np.array(devs), (AXIS,))
    k = mesh.shape[AXIS]
    b = cfg.sampler.batch_size
    fanouts = tuple(cfg.sampler.fanouts)
    num_classes = cfg.dataset.num_classes or data.num_classes

    # ---- partition + per-process shard loading -----------------------------
    t0 = time.perf_counter()
    if (getattr(data, "partition", None) is not None
            and int(np.asarray(data.partition).max()) + 1 == k):
        # precomputed k-way partition from the dataset dir (the
        # reference's XtraPulp partition_<k>_bn file,
        # src/GPUGraphStore.cu:324-339)
        part = np.asarray(data.partition).astype(np.int32)
        log(f"using precomputed {k}-way partition from dataset")
    else:
        part = partition_graph(data, k, mode="greedy")
    cut = edge_cut_fraction(data, part)
    owned, sp, si, fr = put_shards_distributed(
        data.indptr, data.indices, data.features, part, mesh)
    log(f"partitioned {k} ways in {time.perf_counter()-t0:.1f}s, "
        f"edge cut {cut:.3f} (process {pid}/{nproc})")

    shards = shard_node_set(np.asarray(data.train_ids), k, part)
    plan = make_seed_plan([len(s) for s in shards],
                          [max(len(data.valid_ids), 1)] * k,
                          [max(len(data.test_ids), 1)] * k, b,
                          cfg.sampler.eval_batch_size)

    caps = frontier_caps(b, fanouts)
    eval_caps = frontier_caps(cfg.sampler.eval_batch_size, fanouts)

    # exact halo exchange: probe per-distance request maxima and size
    # the non-uniform ppermute caps; over-cap requests
    # fail loudly via the halo_overflow meters below. ONE cap set
    # serves the train AND eval programs, so the probe runs at the
    # larger of the two batch shapes (an eval batch above the train
    # batch would otherwise outgrow train-probed caps).
    def eval_schedule(ids: np.ndarray):
        """The deterministic eval chunking — ONE definition shared by
        the cap probe and eval_set below, so the probed batches are
        exactly the batches eval runs."""
        eshards = shard_node_set(ids, k, part)
        cap = cfg.sampler.eval_batch_size
        mx = max(max(len(s) for s in eshards), 1)
        steps_e = (mx - 1) // cap + 1
        per = tuple((len(s) - 1) // steps_e + 1 if len(s) else 0
                    for s in eshards)
        seeds_e, counts_e = epoch_eval_seeds(eshards, steps_e, per, cap)
        return seeds_e, counts_e, steps_e

    dist_caps = None
    if cfg.parallel.halo_exchange == "exact":
        probe_b = max(b, cfg.sampler.eval_batch_size)
        probe_caps = tuple(max(c, e) for c, e in zip(caps, eval_caps)) \
            if probe_b > b else caps
        # probe every seed COMPOSITION the caps will serve, not just the
        # largest batch shape: valid/test seeds can concentrate on
        # partition-boundary nodes with a different per-distance skew
        # than train seeds, and eval runs through the same cap set
        # (over-cap eval rows would come back zeroed — loudly metered,
        # but the probe should prevent it, not the meter catch it).
        # Train batches are random draws, so random probe subsets cover
        # them; the eval schedule is DETERMINISTIC chunks
        # (epoch_eval_seeds), so those exact batches are probed — a
        # random shard subset can miss a boundary-clustered chunk.
        cap_sets = [probe_dist_caps(
            data.indptr, data.indices, part, shards, fanouts,
            probe_caps, k, probe_b,
            slack=cfg.parallel.halo_cap_slack,
            probes=cfg.parallel.halo_probe_batches,
            seed=cfg.train.seed)]
        for ids_e in (np.asarray(data.valid_ids),
                      np.asarray(data.test_ids)):
            if not len(ids_e):
                continue
            seeds_e, _, steps_e = eval_schedule(ids_e)
            cap_sets.append(probe_dist_caps_batches(
                data.indptr, data.indices, part,
                [(i, seeds_e[i, t]) for t in range(steps_e)
                 for i in range(k)],
                fanouts, probe_caps, k,
                slack=cfg.parallel.halo_cap_slack,
                seed=cfg.train.seed))
        dist_caps = tuple(max(c) for c in zip(*cap_sets))
        log(f"halo exact exchange: per-distance caps {dist_caps} "
            f"(frontier cap {probe_caps[-1]}, slack "
            f"{cfg.parallel.halo_cap_slack})")
    owner = owner_table(part, mesh, enabled=dist_caps is not None)

    # ---- model/state (shape-only init: no graph access) -------------------
    model = build_model(cfg.model.arch, cfg.model.hidden_dim, num_classes,
                        cfg.model.num_layers, cfg.model.dropout,
                        dtype=cfg.model.dtype)
    x0 = jnp.zeros((caps[-1], data.feature_dim), jnp.float32)
    params = model.init(jax.random.PRNGKey(cfg.train.seed),
                        tuple(reversed(_dummy_blocks(caps, fanouts))), x0,
                        deterministic=True)["params"]
    state = create_train_state(params, cfg.train.learning_rate,
                               cfg.train.seed)
    if cfg.train.checkpoint_dir:
        restored = restore_checkpoint(cfg.train.checkpoint_dir, state)
        if restored is not None:
            state = restored
            log(f"resumed from checkpoint at step {int(state.step)}, "
                f"epoch {int(state.epoch)}")
    rep = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P(AXIS))
    mat = NamedSharding(mesh, P(None, AXIS))
    state = jax.device_put(state, rep)

    jit_epoch, jit_eval = make_partitioned_epoch_fns(
        cfg, model, caps, mesh, eval_caps, dist_caps=dist_caps)
    labels_all = np.asarray(data.labels)
    nb = jax.device_put(np.full((k,), b, np.int32), row)

    def eval_set(ids: np.ndarray) -> float:
        if not len(ids):
            return float("nan")
        seeds_e, counts_e, _ = eval_schedule(ids)
        lab_e = np.where(seeds_e >= 0,
                         labels_all[np.clip(seeds_e, 0, None)],
                         -1).astype(np.int32)
        c, n, ov = jit_eval(
            state.params, owned, sp, si, fr, owner,
            jax.device_put(interleave_shards(seeds_e), mat),
            jax.device_put(np.ascontiguousarray(counts_e.swapaxes(0, 1)),
                           mat),
            jax.device_put(interleave_shards(lab_e), mat),
            jax.device_put(jax.random.PRNGKey(12345), rep))
        ov = int(jax.device_get(ov))
        if ov > 0:
            from legion.utils.logging import log_metrics
            log_metrics({"event": "halo_overflow", "phase": "eval",
                         "dropped_requests": ov,
                         "hint": "raise parallel.halo_cap_slack"})
        return float(jax.device_get(c)) / max(float(jax.device_get(n)),
                                              1.0)

    history = []
    start_epoch = int(jax.device_get(state.epoch))
    for epoch in range(start_epoch, cfg.train.epochs):
        ep_rng = np.random.default_rng(cfg.train.seed * 100003 + epoch)
        s, _ = epoch_train_seeds(ep_rng, shards, plan)   # (k, steps, b)
        lab = np.where(s >= 0, labels_all[np.clip(s, 0, None)],
                       -1).astype(np.int32)
        state = jax.device_put(
            state.replace(epoch=jnp.full((), epoch, jnp.int32)), rep)
        t0 = time.perf_counter()
        state, losses, edges, halo_ov = jit_epoch(
            state, owned, sp, si, fr, owner,
            jax.device_put(interleave_shards(s), mat), nb,
            jax.device_put(interleave_shards(lab), mat))
        losses = jax.device_get(losses)
        dt = time.perf_counter() - t0
        halo_ov = int(jax.device_get(halo_ov))
        if halo_ov > 0:
            from legion.utils.logging import log_metrics
            log_metrics({"event": "halo_overflow", "epoch": epoch,
                         "dropped_requests": halo_ov,
                         "hint": "raise parallel.halo_cap_slack"})
        from legion.train.loop import sum_edge_counts
        rec = {"epoch": epoch, "loss": float(losses[-1]),
               "mean_loss": float(losses.mean()), "seconds": dt,
               "edges_per_s": sum_edge_counts(edges) / dt,
               "edge_cut": cut, "halo_overflow": halo_ov}
        rec["valid"] = eval_set(np.asarray(data.valid_ids))
        history.append(rec)
        from legion.utils.logging import eval_labels
        log(f"Epoch:{epoch}, Cost:{dt:.3f} s, Loss:{rec['loss']:.4f}, "
            f"{eval_labels(cfg)[0]}: {rec['valid']:.4f}, edges/s: "
            f"{rec['edges_per_s']:.3e} [{k}-way partitioned]")
        if cfg.train.checkpoint_dir:
            state = state.replace(
                epoch=jnp.full((), epoch + 1, jnp.int32))
            save_checkpoint(cfg.train.checkpoint_dir, state)
    test_acc = eval_set(np.asarray(data.test_ids))
    from legion.utils.logging import eval_labels
    log(f"{eval_labels(cfg)[1]}: {test_acc:.4f}")
    return {"state": state, "history": history, "test_acc": test_acc,
            "edge_cut": cut, "mesh": dict(mesh.shape)}
