"""Synthetic graph generators for tests and benchmarks.

The reference validates only on downloaded OGB/WebGraph datasets; this
module provides in-memory generators with controllable scale and skew so
the test pyramid (SURVEY.md §4) and benchmarks run hermetically (no
network). Hotness skew is controllable because the cache subsystem's
whole point is exploiting power-law access distributions.
"""

from __future__ import annotations

import os

import numpy as np

from legion.data.format import GraphData, from_coo


def random_power_law_graph(
    num_nodes: int = 10_000,
    avg_degree: int = 15,
    feature_dim: int = 32,
    num_classes: int = 10,
    alpha: float = 0.8,
    seed: int = 0,
    train_frac: float = 0.6,
    valid_frac: float = 0.2,
) -> GraphData:
    """Directed graph whose in-neighbor targets follow a Zipf-like skew.

    Edge (src, dst): src features aggregate into dst. Neighbor sources are
    drawn with probability proportional to ``rank^-alpha`` so a small hot
    set dominates — the regime Legion's hotness cache targets.

    Labels are generated from a planted linear model over features plus
    neighborhood mixing, so a GNN genuinely beats chance and training
    curves are meaningful in tests.
    """
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree

    # Skewed popularity over source nodes (hot ids are random, not 0..k,
    # so tests catch accidental id/rank confusion).
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm = rng.permutation(num_nodes)
    src = perm[rng.choice(num_nodes, size=num_edges, p=probs)]
    dst = rng.integers(0, num_nodes, size=num_edges)

    feats = rng.standard_normal((num_nodes, feature_dim), dtype=np.float32)

    # Planted labels: project node + 1-hop-mean features through a random
    # linear map; argmax defines the class.
    w = rng.standard_normal((feature_dim, num_classes)).astype(np.float32)
    agg = np.zeros_like(feats)
    np.add.at(agg, dst, feats[src])
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float32)[:, None]
    agg = agg / np.maximum(deg, 1.0)
    logits = (feats + agg) @ w + 0.5 * rng.standard_normal((num_nodes, num_classes)).astype(np.float32)
    labels = logits.argmax(axis=1).astype(np.int32)

    ids = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * train_frac)
    n_valid = int(num_nodes * valid_frac)
    return from_coo(
        src=src.astype(np.int32), dst=dst.astype(np.int32),
        num_nodes=num_nodes, features=feats, labels=labels,
        train_ids=ids[:n_train],
        valid_ids=ids[n_train:n_train + n_valid],
        test_ids=ids[n_train + n_valid:],
    )


def inverse_cdf(cdf: np.ndarray, u: np.ndarray, bits: int = 22
                ) -> np.ndarray:
    """``np.searchsorted(cdf, u)`` as int32, for a non-decreasing ``cdf``
    ending at 1.0 and draws ``u`` in [0, 1). A table of 2**bits bucket
    bounds narrows each search to the few entries between its bucket's
    bounds, so a draw costs a couple of gathers instead of a binary
    search over the whole cdf (about 9x faster at products scale)."""
    m = 1 << bits
    lo = np.searchsorted(cdf, np.arange(m + 1, dtype=np.float64) / m
                         ).astype(np.int32)
    # u * m is exact (m is a power of two): lo[k] <= answer <= lo[k + 1]
    idx = lo[(u * m).astype(np.int32)]
    last = cdf.shape[0] - 1
    for _ in range(int((lo[1:] - lo[:-1]).max())):
        idx += cdf[np.minimum(idx, last)] < u
    return idx


def bench_graph(num_nodes: int = 2_449_029, avg_degree: int = 50,
                feature_dim: int = 100, num_classes: int = 47,
                alpha: float = 0.8, seed: int = 0,
                train_frac: float = 0.08) -> GraphData:
    """Products-scale synthetic graph for benchmarks (hermetic stand-in
    for ogbn-products: 2.45M nodes / ~123M edges / feat 100 / 47 classes,
    ``legion_server.py:6-13``). Optimized generation: inverse-CDF Zipf
    sampling + random labels — no planted-label pass, which would
    dominate generation time at this scale."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree

    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    perm = rng.permutation(num_nodes).astype(np.int32)
    src = perm[inverse_cdf(cdf, rng.random(num_edges))]
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)

    # CSR directly: src is drawn independently of dst, so the i.i.d.
    # src sequence in draw order is already a valid CSR row layout for
    # the dst degree counts — no sort over the edges is needed.
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=indptr[1:])
    del dst
    indices = src

    feats = rng.standard_normal((num_nodes, feature_dim), dtype=np.float32)
    labels = rng.integers(0, num_classes, size=num_nodes, dtype=np.int32)
    ids = rng.permutation(num_nodes).astype(np.int32)
    n_train = int(num_nodes * train_frac)
    return GraphData(indptr=indptr, indices=indices, features=feats,
                     labels=labels, train_ids=ids[:n_train],
                     valid_ids=ids[n_train:n_train + n_train // 4],
                     test_ids=ids[n_train + n_train // 4:
                                  n_train + n_train // 2])


def _stream_indptr(f, counts: np.ndarray, chunk_nodes: int) -> int:
    """Write the int64 indptr for per-node edge counts in chunks (the
    running offset is int64 throughout — cumulative sums pass 2^35 at
    the uk2014/clueweb registry rows; pinned by tests/test_bigcsr.py).
    Returns the total edge count."""
    np.zeros(1, np.int64).tofile(f)
    run = np.int64(0)
    for s in range(0, len(counts), chunk_nodes):
        c = counts[s: s + chunk_nodes].astype(np.int64, copy=False)
        out = np.cumsum(c) + run
        run = out[-1]
        out.tofile(f)
    return int(run)


def streaming_power_law_graph(
    path: str,
    num_nodes: int,
    avg_degree: float,
    feature_dim: int = 32,
    num_classes: int = 100,
    alpha: float = 0.8,
    seed: int = 0,
    train_num: int = 800_000,
    valid_num: int = 16_000,
    test_num: int = 16_000,
    chunk_nodes: int = 2_000_000,
    communities: int = 0,
    intra_frac: float = 0.8,
    log=print,
) -> str:
    """Generate a packed dataset DIRECTLY on disk with bounded RAM —
    the billion-edge (uk-union / clueweb class) generator. bench_graph
    materializes src+dst+argsort in memory (~24B/edge: 130+ GB at 5.5B
    edges); this writes the CSR in node order straight into the packed
    files (data.format layout), so peak RAM is ~3 float64/node for the
    Zipf CDF + one chunk of draws.

    In-degrees are Poisson(avg_degree) (num_edges = their sum, recorded
    in meta.json); neighbor sources are Zipf(alpha)-popular over a
    permuted id space (the reference's billion-scale datasets are
    heavy-tailed web graphs, ``legion_server.py:30-53``). Returns path.

    communities > 0 plants block structure (VERDICT r4 next #5: the
    uniform-destination synthetic gives a partitioner nothing to find —
    real web graphs cluster, which is why XtraPulp exists,
    ``prepare_dataset.sh:44``): nodes are assigned to ``communities``
    random groups, and each edge's source is drawn from the
    destination's OWN community with probability ``intra_frac``
    (Zipf-skewed within the community), else from the global Zipf. A
    good partitioner can then cut ~(1-intra_frac) of edges where hash
    cuts ~(K-1)/K. Adds 8 bytes/node of RAM (community permutation +
    inverse).
    """
    import json as _json
    import time as _time
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)

    t0 = _time.time()
    # in-degrees + streamed int64 indptr
    counts = rng.poisson(avg_degree, num_nodes).astype(np.int64)
    with open(os.path.join(path, "edge_src"), "wb") as f:
        num_edges = _stream_indptr(f, counts, chunk_nodes)
    log(f"indptr written ({num_edges} edges) {_time.time()-t0:.0f}s")

    # Zipf CDF over permuted source ids
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-alpha))
    cdf /= cdf[-1]
    perm = rng.permutation(num_nodes).astype(np.int32)

    if communities > 1:
        csize = -(-num_nodes // communities)          # ceil
        cperm = rng.permutation(num_nodes).astype(np.int32)
        cinv = np.empty(num_nodes, np.int32)
        cinv[cperm] = np.arange(num_nodes, dtype=np.int32)
        lranks = np.arange(1, csize + 1, dtype=np.float64)
        lcdf = np.cumsum(lranks ** (-alpha))
        lcdf /= lcdf[-1]

    with open(os.path.join(path, "edge_dst"), "wb") as f:
        done = 0
        for s in range(0, num_nodes, chunk_nodes):
            c = counts[s: s + chunk_nodes]
            e = int(c.sum())
            src = perm[np.searchsorted(
                cdf, rng.random(e)).astype(np.int64)]
            if communities > 1 and e:
                # destination node of each edge in this chunk
                dst = (np.int64(s)
                       + np.repeat(np.arange(len(c), dtype=np.int64), c))
                comm = cinv[dst] // csize
                base = comm.astype(np.int64) * csize
                size_c = np.minimum(csize, num_nodes - base)
                lr = np.minimum(
                    np.searchsorted(lcdf, rng.random(e)).astype(np.int64),
                    size_c - 1)
                intra = rng.random(e) < intra_frac
                src = np.where(intra, cperm[base + lr], src)
            src.astype(np.int32).tofile(f)
            done += e
            if (s // chunk_nodes) % 8 == 0:
                log(f"  edges {done}/{num_edges} "
                    f"{_time.time()-t0:.0f}s")
    del cdf
    log(f"indices written {_time.time()-t0:.0f}s")

    with open(os.path.join(path, "features"), "wb") as f:
        for s in range(0, num_nodes, chunk_nodes):
            m = min(chunk_nodes, num_nodes - s)
            rng.standard_normal((m, feature_dim),
                                dtype=np.float32).tofile(f)
    log(f"features written {_time.time()-t0:.0f}s")

    rng.integers(0, num_classes, num_nodes,
                 dtype=np.int32).tofile(os.path.join(path, "labels"))
    total = train_num + valid_num + test_num
    ids = rng.choice(num_nodes, size=total, replace=False).astype(np.int32)
    ids[:train_num].tofile(os.path.join(path, "trainingset"))
    ids[train_num:train_num + valid_num].tofile(
        os.path.join(path, "validationset"))
    ids[train_num + valid_num:].tofile(os.path.join(path, "testingset"))

    with open(os.path.join(path, "meta.json"), "w") as f:
        _json.dump({
            "num_nodes": num_nodes, "num_edges": num_edges,
            "feature_dim": feature_dim, "num_classes": num_classes,
            "train_num": train_num, "valid_num": valid_num,
            "test_num": test_num,
        }, f, indent=2)
    log(f"dataset complete {_time.time()-t0:.0f}s")
    return path


def chain_graph(num_nodes: int = 8, feature_dim: int = 4) -> GraphData:
    """Tiny deterministic chain 0<-1<-2<-...: node v's only in-neighbor is
    v+1. Features are one-hots; used for hand-checkable sampler tests."""
    src = np.arange(1, num_nodes, dtype=np.int32)
    dst = np.arange(0, num_nodes - 1, dtype=np.int32)
    feats = np.eye(num_nodes, feature_dim, dtype=np.float32)
    labels = (np.arange(num_nodes) % 2).astype(np.int32)
    ids = np.arange(num_nodes, dtype=np.int32)
    return from_coo(src, dst, num_nodes, feats, labels, ids, ids[:0], ids[:0])
