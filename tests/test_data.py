"""Data layer tests: packed format round-trip, COO->CSR, partitioning."""

import numpy as np
import pytest

from legion.data.format import from_coo, load_dataset, save_dataset
from legion.data.partition import edge_cut_fraction, partition_graph


def test_format_roundtrip(small_graph, tmp_path):
    save_dataset(small_graph, str(tmp_path / "ds"))
    g = load_dataset(str(tmp_path / "ds"))
    np.testing.assert_array_equal(g.indptr, small_graph.indptr)
    np.testing.assert_array_equal(g.indices, small_graph.indices)
    np.testing.assert_allclose(g.features, small_graph.features)
    np.testing.assert_array_equal(g.train_ids, small_graph.train_ids)
    g.validate()


def test_from_coo_orientation():
    # edge (src=5, dst=2): 5's features flow into 2 => row 2 contains 5
    src = np.array([5, 4, 5], np.int32)
    dst = np.array([2, 2, 0], np.int32)
    g = from_coo(src, dst, 6, np.zeros((6, 2), np.float32),
                 np.zeros(6, np.int32), np.arange(6, dtype=np.int32),
                 np.array([], np.int32), np.array([], np.int32))
    assert g.indices[g.indptr[2]:g.indptr[3]].tolist() == [5, 4]
    assert g.indices[g.indptr[0]:g.indptr[1]].tolist() == [5]


def test_partition_modes(small_graph):
    for mode in ("hash", "greedy"):
        part = partition_graph(small_graph, 4, mode=mode)
        assert part.shape == (small_graph.num_nodes,)
        assert set(np.unique(part)) <= {0, 1, 2, 3}
        sizes = np.bincount(part, minlength=4)
        assert sizes.min() > 0.5 * small_graph.num_nodes / 4
    # greedy should cut fewer edges than hash on a clustered-ish graph
    cut_h = edge_cut_fraction(small_graph, partition_graph(small_graph, 4, "hash"))
    cut_g = edge_cut_fraction(small_graph, partition_graph(small_graph, 4, "greedy"))
    assert cut_g <= cut_h + 0.02


def test_partition_chunked_matches_sequential_quality(small_graph):
    """The scalable chunked greedy must stay within
    10% edge cut of the sequential greedy oracle, with balance held, even
    when forced through many small chunks (chunk boundaries are where
    its approximation lives)."""
    k = 4
    seq = partition_graph(small_graph, k, mode="greedy_seq")
    cut_seq = edge_cut_fraction(small_graph, seq)
    for chunk in (64, 256, 10 ** 9):
        part = partition_graph(small_graph, k, mode="greedy",
                               chunk_size=chunk)
        sizes = np.bincount(part, minlength=k)
        cap = int(small_graph.num_nodes / k * 1.05) + 1
        assert sizes.max() <= cap, (chunk, sizes)
        assert sizes.min() > 0, (chunk, sizes)
        cut = edge_cut_fraction(small_graph, part)
        assert cut <= cut_seq + 0.10, (
            f"chunk {chunk}: cut {cut:.3f} vs sequential {cut_seq:.3f}")


def test_ogb_converter_with_mock(tmp_path, monkeypatch):
    """convert_ogb_node_dataset end-to-end against a mocked ogb package
    (the real one is unavailable in the zero-egress build env): reverse
    edges, COO->CSR via the C++ runtime, NaN labels -> -1, split ids,
    packed round-trip."""
    import sys
    import types

    n = 6
    edge_index = np.array([[0, 1, 2, 4], [1, 2, 3, 5]])
    feats = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    labels = np.array([[0.0], [1.0], [np.nan], [2.0], [1.0], [np.nan]])
    split = {"train": np.array([0, 1]), "valid": np.array([2]),
             "test": np.array([3, 4])}

    class FakeDS:
        def __init__(self, name, root):
            assert name == "ogbn-fake"

        def __getitem__(self, i):
            return ({"num_nodes": n, "edge_index": edge_index,
                     "node_feat": feats}, labels)

        def get_idx_split(self):
            return split

    mod = types.ModuleType("ogb.nodeproppred")
    mod.NodePropPredDataset = FakeDS
    pkg = types.ModuleType("ogb")
    pkg.nodeproppred = mod
    monkeypatch.setitem(sys.modules, "ogb", pkg)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", mod)

    from legion.data.ogb import convert_ogb_node_dataset
    out = tmp_path / "fake"
    g = convert_ogb_node_dataset("ogbn-fake", str(tmp_path), str(out),
                                 add_reverse=True, partitions=2)

    # undirected CSR: each edge appears both ways
    assert int(g.indptr[-1]) == 2 * edge_index.shape[1]
    adj0 = np.asarray(g.indices[g.indptr[0]:g.indptr[1]])
    assert list(adj0) == [1]                       # 0->1 and reverse 1->0
    adj1 = sorted(np.asarray(g.indices[g.indptr[1]:g.indptr[2]]))
    assert adj1 == [0, 2]
    assert list(np.asarray(g.labels)) == [0, 1, -1, 2, 1, -1]

    r = load_dataset(str(out), mmap=False)
    np.testing.assert_array_equal(np.asarray(r.indptr), np.asarray(g.indptr))
    np.testing.assert_array_equal(np.asarray(r.features), feats)
    np.testing.assert_array_equal(np.asarray(r.train_ids), [0, 1])
    np.testing.assert_array_equal(np.asarray(r.test_ids), [3, 4])


def test_stream_indptr_arithmetic_past_2_35(tmp_path):
    """The streaming generator's chunked indptr accumulator at
    uk2014-envelope magnitudes: 64 nodes of 2^30 edges each -> offsets
    past 2^35, written chunk by chunk, no wrap."""
    from legion.data.synthetic import _stream_indptr
    counts = np.full(64, 1 << 30, np.int64)
    fp = tmp_path / "indptr.bin"
    with open(fp, "wb") as f:
        total = _stream_indptr(f, counts, chunk_nodes=16)
    assert total == 64 << 30 and total > 2 ** 35
    arr = np.fromfile(fp, np.int64)
    assert len(arr) == 65
    assert arr[0] == 0 and arr[1] == 1 << 30 and arr[-1] == total
    np.testing.assert_array_equal(np.diff(arr), counts)


def test_clustered_generator_greedy_beats_hash(tmp_path):
    """Planted-community streaming generator: the
    uniform-destination synthetic gave the partitioner nothing to find;
    with block structure the chunked greedy must cut FAR fewer edges
    than hash — the locality premise the whole partitioned/halo path
    rests on."""
    from legion.data.format import load_dataset
    from legion.data.partition import edge_cut_fraction, partition_graph
    from legion.data.synthetic import streaming_power_law_graph
    p = streaming_power_law_graph(
        str(tmp_path / "cds"), num_nodes=20_000, avg_degree=8,
        feature_dim=4, num_classes=5, train_num=2000, valid_num=200,
        test_num=200, chunk_nodes=4096, communities=16, intra_frac=0.8,
        log=lambda s: None)
    g = load_dataset(p)
    g.validate()
    cut_hash = edge_cut_fraction(g, partition_graph(g, 4, mode="hash"))
    cut_greedy = edge_cut_fraction(
        g, partition_graph(g, 4, mode="greedy", chunk_size=512))
    # hash cuts ~(K-1)/K regardless; greedy must exploit the planted
    # blocks (~intra_frac of edges are recoverable)
    assert cut_hash > 0.70, cut_hash
    assert cut_greedy < 0.6 * cut_hash, (cut_greedy, cut_hash)
    # balance still holds
    part = partition_graph(g, 4, mode="greedy", chunk_size=512)
    sizes = np.bincount(part, minlength=4)
    assert sizes.max() <= int(g.num_nodes / 4 * 1.06) + 1


@pytest.mark.parametrize("n,alpha,bits", [(1000, 0.8, 4), (100_000, 0.8, 10),
                                          (100_000, 0.8, 22),
                                          (5000, 0.0, 6)])
def test_inverse_cdf_equals_searchsorted(n, alpha, bits):
    """bench_graph's bucketed inverse CDF draws exactly the ids a binary
    search over the cdf does, however coarse its bucket table."""
    from legion.data.synthetic import inverse_cdf
    rng = np.random.default_rng(n)
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** (-alpha))
    cdf /= cdf[-1]
    u = np.concatenate([rng.random(200_000), cdf[:50],
                        [0.0, np.nextafter(1.0, 0.0)]])
    got = inverse_cdf(cdf, u, bits=bits)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.searchsorted(cdf, u))
