"""One-command OGB parity harness (tools/parity_ogb.py), CI-tested
end-to-end against a mocked ogb package: convert -> packed dir -> train
with (scaled-down) reference hyperparameters -> accuracy verdict + exit
code. The day real OGB data is mountable, parity is
`python tools/parity_ogb.py --name ogbn-products --ogb-root <dir>`."""

import json
import sys
import types

import numpy as np
import pytest


@pytest.fixture
def fake_ogb(monkeypatch, small_graph):
    """Mock ogb.nodeproppred.NodePropPredDataset serving small_graph
    (planted labels: a GNN genuinely beats chance) as COO."""
    indptr = np.asarray(small_graph.indptr)
    indices = np.asarray(small_graph.indices)
    dst = np.repeat(np.arange(small_graph.num_nodes), np.diff(indptr))
    edge_index = np.stack([indices.astype(np.int64),
                           dst.astype(np.int64)])
    labels = np.asarray(small_graph.labels, np.float64)[:, None]
    split = {"train": np.asarray(small_graph.train_ids),
             "valid": np.asarray(small_graph.valid_ids),
             "test": np.asarray(small_graph.test_ids)}

    class FakeDS:
        def __init__(self, name, root):
            assert name == "ogbn-products"

        def __getitem__(self, i):
            return ({"num_nodes": small_graph.num_nodes,
                     "edge_index": edge_index,
                     "node_feat": np.asarray(small_graph.features)},
                    labels)

        def get_idx_split(self):
            return split

    mod = types.ModuleType("ogb.nodeproppred")
    mod.NodePropPredDataset = FakeDS
    pkg = types.ModuleType("ogb")
    pkg.nodeproppred = mod
    monkeypatch.setitem(sys.modules, "ogb", pkg)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", mod)
    return FakeDS


def _run(tmp_path, extra):
    from tools.parity_ogb import main
    argv = ["--ogb-root", str(tmp_path), "--name", "ogbn-products",
            "--batch-size", "64", "--fanouts", "4,3",
            "--hidden-dim", "16", "--dropout", "0.0",
            "--lr", "0.01", "--epochs", "2", "--dtype", "float32",
            ] + extra
    return main(argv)


def test_parity_harness_pass_and_artifacts(tmp_path, fake_ogb, capsys):
    chance = 1.0 / 7  # small_graph has 7 classes
    rc = _run(tmp_path, ["--target", f"{1.5 * chance:.3f}"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(out)
    assert rc == 0
    assert rec["parity"] == "PASS"
    assert rec["test_acc"] > 1.5 * chance
    assert np.isfinite(rec["valid_acc"])
    # the converted packed dir exists and is reusable (conversion must be
    # skipped on the second run)
    assert (tmp_path / "ogbn_products_packed" / "meta.json").exists()


def test_parity_harness_fails_loudly_on_gap(tmp_path, fake_ogb, capsys):
    rc = _run(tmp_path, ["--target", "0.99"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert rec["parity"] == "FAIL"
    assert rec["gap"] > rec["tolerance"]


def test_parity_targets_pinned():
    """The pinned targets must match docs/PARITY.md's plan (products
    SAGE ~0.78, GCN ~0.75, papers100M SAGE ~0.64+)."""
    from tools.parity_ogb import TARGETS
    assert TARGETS[("ogbn-products", "sage")] == 0.78
    assert TARGETS[("ogbn-products", "gcn")] == 0.75
    assert TARGETS[("ogbn-papers100M", "sage")] >= 0.64
