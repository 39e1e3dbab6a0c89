"""Packed-dataset CLI path: the exact command shape
the real-data parity plan depends on — load a dataset DIRECTORY from
disk, train, eval — proven end-to-end in CI on a synthetic graph written
by save_dataset, including the precomputed-partition file and the
registry-vs-meta.json mismatch guard."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from legion.data.format import load_dataset, save_dataset
from legion.data.synthetic import random_power_law_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def packed_dir(tmp_path_factory):
    g = random_power_law_graph(num_nodes=1500, avg_degree=8,
                               feature_dim=32, num_classes=7, seed=2)
    g = dataclasses.replace(
        g, partition=(np.arange(g.num_nodes) % 2).astype(np.int32))
    d = str(tmp_path_factory.mktemp("packed") / "ds")
    save_dataset(g, d)
    return d


def _run(args, timeout=900):
    env = dict(os.environ, LEGION_FORCE_CPU_DEVICES="8")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "train.py")] + args,
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_cli_trains_from_packed_dir(packed_dir):
    """load -> train -> eval from disk through the CLI."""
    r = _run(["--data-dir", packed_dir, "--epochs", "2",
              "--batch-size", "32", "--fanouts", "4,3",
              "--hidden-dim", "16"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Val Acc" in r.stdout
    assert "Accuracy on test data" in r.stdout


def test_cli_registry_mismatch_fails_loudly(packed_dir):
    """--dataset PR against a non-products directory must REFUSE to
    train (the reference trusts meta_config blindly; we don't)."""
    r = _run(["--dataset", "PR", "--data-dir", packed_dir,
              "--epochs", "1"])
    assert r.returncode != 0
    assert "registry expects" in r.stderr
    assert "wrong directory or bad conversion" in r.stderr


def test_cli_partitioned_honors_partition_file(packed_dir):
    """--partitioned --devices 2 picks up partition_2_bn from the
    dataset dir (the reference's XtraPulp partition file path,
    src/GPUGraphStore.cu:324-339)."""
    r = _run(["--data-dir", packed_dir, "--partitioned", "--devices", "2",
              "--epochs", "1", "--batch-size", "32", "--fanouts", "4,3",
              "--hidden-dim", "16"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "using precomputed 2-way partition" in r.stdout
    assert "Accuracy on test data" in r.stdout


def test_cli_halo_flags(packed_dir):
    """--halo-exchange/--halo-cap-slack reach the partitioned driver
    (psum mode runs; exact is the default with its probe log) and warn
    when passed to a non-partitioned driver (no silently-ignored
    flags)."""
    r = _run(["--data-dir", packed_dir, "--partitioned", "--devices", "2",
              "--epochs", "1", "--batch-size", "32", "--fanouts", "4,3",
              "--hidden-dim", "16", "--halo-exchange", "psum"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"halo_exchange": "psum"' in r.stdout
    assert "halo exact exchange" not in r.stdout

    r = _run(["--data-dir", packed_dir, "--partitioned", "--devices", "2",
              "--epochs", "1", "--batch-size", "32", "--fanouts", "4,3",
              "--hidden-dim", "16", "--halo-cap-slack", "1.5"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "halo exact exchange: per-distance caps" in r.stdout

    r = _run(["--data-dir", packed_dir, "--epochs", "1",
              "--batch-size", "32", "--fanouts", "4,3",
              "--hidden-dim", "16", "--halo-exchange", "psum"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "apply only to --partitioned" in r.stderr


def test_cli_auto_cache_group(packed_dir):
    """Unset --cache-group with a cache defaults to the largest mesh
    divisor inside the local device count (reference: cache_agg_mode
    derived from NVLink topology, legion_server.py:61-68)."""
    r = _run(["--data-dir", packed_dir, "--epochs", "1",
              "--batch-size", "32", "--fanouts", "4,3",
              "--hidden-dim", "16", "--devices", "4",
              "--cache-budget-gb", "0.001"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "auto --cache-group 4" in r.stderr
    assert '"group_size": 4' in r.stdout


def test_cli_explicit_cache_group_cross_host_warns(packed_dir):
    """An explicit Kg beyond the local device count warns that stripe
    exchange leaves the host."""
    r = _run(["--data-dir", packed_dir, "--epochs", "1",
              "--batch-size", "32", "--fanouts", "4,3",
              "--devices", "16", "--cache-group", "16",
              "--cache-budget-gb", "0.001"])
    # 16 devices don't exist on the CI mesh, so the run itself fails —
    # the warning must have fired first.
    assert "exceeds the 8 local devices" in r.stderr


def test_loader_partition_roundtrip(packed_dir):
    data = load_dataset(packed_dir, partition_count=2)
    assert data.partition is not None
    assert int(np.asarray(data.partition).max()) == 1
    meta = json.load(open(os.path.join(packed_dir, "meta.json")))
    assert meta["num_nodes"] == data.num_nodes
