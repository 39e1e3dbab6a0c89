"""Multi-host launch scaffolding: ``jax.distributed`` initialization +
per-process shard loading.

Beyond-reference capability (the reference is single-node, ``MAX_DEVICE
8``, ``src/CUDA_IPC_Service.cu:16``; its only multi-node element is the
offline XtraPulp MPI partitioner, ``prepare_dataset.sh:44``). Here a
real multi-host run is one process per host:

    LEGION_COORDINATOR=host0:1234 LEGION_NUM_PROCESSES=4 \
    LEGION_PROCESS_ID=$RANK python train.py --partitioned ...

Each process calls ``jax.distributed.initialize``, sees the global
device set, builds ONLY the graph/feature shards its local devices own
(``HostShard.build_one`` — it never materializes another host's
partition), and assembles the globally-sharded arrays with
``jax.make_array_from_process_local_data``. With no coordinator in the
environment everything degrades to the single-process path (the CI
virtual mesh runs the identical code).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from legion.parallel.halo import HostShard
from legion.parallel.multihost import AXIS


def maybe_initialize_distributed() -> Tuple[int, int]:
    """Initialize the jax.distributed runtime when a coordinator is
    configured; returns (process_count, process_index). Safe to call
    twice (initialization errors on an already-initialized runtime are
    swallowed); a no-op single-process fallback otherwise."""
    addr = os.environ.get("LEGION_COORDINATOR")
    if addr:
        n = int(os.environ["LEGION_NUM_PROCESSES"])
        pid = int(os.environ["LEGION_PROCESS_ID"])
        try:
            jax.distributed.initialize(coordinator_address=addr,
                                       num_processes=n, process_id=pid)
        except RuntimeError as e:  # already initialized
            if "already" not in str(e).lower():
                raise
    return jax.process_count(), jax.process_index()


def local_part_ids(mesh: Mesh) -> List[int]:
    """Mesh positions (= partition ids) of THIS process's devices along
    the data axis. On the single-process virtual mesh this is all of
    them; on a pod slice it is the host's addressable chips."""
    flat = mesh.devices.reshape(-1)
    me = jax.process_index()
    return [i for i, d in enumerate(flat) if d.process_index == me]


def put_shards_distributed(indptr, indices, features,
                           partition: np.ndarray, mesh: Mesh):
    """Per-process shard loading + global placement.

    Every process computes the agreed padded shapes from the partition
    vector alone (HostShard.part_shapes), builds only its own parts, and
    contributes them as process-local data to the (K, ...) globally
    sharded arrays. Returns (owned, sub_indptr, sub_indices, feat_rows)
    stacked and sharded P(data), exactly like
    make_partitioned_train_step's put_shards — which this supersedes.
    """
    k = mesh.shape[AXIS]
    rows, edges = HostShard.part_shapes(indptr, partition, k)
    max_c, max_e = int(rows.max()), max(int(edges.max()), 1)
    mine = local_part_ids(mesh)
    if not mine:
        raise ValueError(
            f"process {jax.process_index()} owns no devices of the "
            f"{k}-way '{AXIS}' mesh — the mesh must include every "
            "process's devices (don't narrow num_devices below the "
            "global device count in a multi-process launch)")
    built = [HostShard.build_one(indptr, indices, features, partition,
                                 p, max_c, max_e) for p in mine]
    sh = NamedSharding(mesh, P(AXIS))
    d = np.asarray(features).shape[1]
    global_shapes = ((k, max_c), (k, max_c + 1), (k, max_e), (k, max_c, d))
    out = []
    for i, gshape in enumerate(global_shapes):
        local = np.stack([b[i] for b in built])
        out.append(jax.make_array_from_process_local_data(
            sh, local, gshape))
    return tuple(out)
