"""OGB -> packed binary converter (offline tooling).

Replaces the reference's dataset prep chain (``prepare_dataset.sh``:
WebGraph jar -> edge list -> custom packer -> XtraPulp MPI partitioner)
with one Python entry point producing the packed layout of
legion.data.format. Runs only where the ``ogb`` package and a
downloaded dataset are available (the build/CI environment is
zero-egress; tests use synthetic graphs instead).
"""

from __future__ import annotations

import numpy as np

from legion.data.format import GraphData, save_dataset


def convert_ogb_node_dataset(name: str, root: str, out_path: str,
                             add_reverse: bool = True,
                             partitions: int | None = None) -> GraphData:
    """Convert an OGB node-property dataset (e.g. ogbn-arxiv,
    ogbn-products, ogbn-papers100M) to the packed binary layout.

    add_reverse: treat the graph as undirected by adding reverse edges
    (standard for ogbn-products/papers100M GraphSAGE baselines).
    """
    from ogb.nodeproppred import NodePropPredDataset  # lazy; optional dep

    ds = NodePropPredDataset(name=name, root=root)
    graph, labels = ds[0]
    split = ds.get_idx_split()
    n = int(graph["num_nodes"])
    src, dst = graph["edge_index"][0], graph["edge_index"][1]
    if add_reverse:
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))

    from legion.runtime import coo_to_csr
    indptr, indices = coo_to_csr(src.astype(np.int32), dst.astype(np.int32), n)

    lab = np.asarray(labels).reshape(-1)
    lab = np.where(np.isnan(lab), -1, lab).astype(np.int32)
    g = GraphData(
        indptr=indptr, indices=indices,
        features=np.ascontiguousarray(graph["node_feat"], np.float32),
        labels=lab,
        train_ids=np.asarray(split["train"], np.int32),
        valid_ids=np.asarray(split["valid"], np.int32),
        test_ids=np.asarray(split["test"], np.int32),
    )
    if partitions:
        from legion.data.partition import partition_graph
        g.partition = partition_graph(g, partitions)
    save_dataset(g, out_path)
    return g
