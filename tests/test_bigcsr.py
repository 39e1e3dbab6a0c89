""">2^31-edge host-CSR addressing seams (VERDICT r3 next #1; r5 extends
to the uk2014/clueweb envelope, VERDICT r4 next #6): every component
that touches the host CSR must use int64 addressing past edge 2^31 —
and past 2^35, the magnitude bracket of the reference registry's two
largest rows (uk2014 47.28B / clueweb 42.57B edges,
``legion_server.py:38-53``). The indices file is a SPARSE memmap (only
the touched pages exist on disk — the uk2014-sized variant is a 176GB
logical file occupying a few KB), so the tests run in CI without
materializing a billion-edge array."""

import json
import os

import numpy as np
import pytest

from legion.config import DATASET_REGISTRY
from legion.data.format import load_dataset

UKL_EDGES = DATASET_REGISTRY["UKL"].num_edges   # 47,284,178,505 > 2^35
N = 1024
DEG = 16


@pytest.fixture(scope="module", params=[2 ** 31 + 512, UKL_EDGES - DEG],
                ids=["past-2^31", "uk2014-tail"])
def big_csr(request, tmp_path_factory):
    """(indptr, indices-memmap): node 0's run at [0, 16), node N-1's run
    at [E_FAR, E_FAR+16) — all other nodes degree 0. Parametrized so the
    far run sits just past int32 AND at the tail of a uk2014-sized file
    (indptr values near 4.73e10)."""
    e_far = request.param
    d = tmp_path_factory.mktemp("bigcsr")
    indptr = np.zeros(N + 1, np.int64)
    indptr[1:] = DEG                      # node 0: [0, DEG)
    indptr[N] = e_far + DEG               # node N-1: [E_FAR, E_FAR+DEG)
    indptr[N - 1] = e_far
    total = e_far + DEG

    fp = str(d / "indices.bin")
    lo = (np.arange(DEG, dtype=np.int32) + 100)
    hi = (np.arange(DEG, dtype=np.int32) + 900)
    with open(fp, "wb") as f:
        lo.tofile(f)
        f.seek(e_far * 4)                 # sparse hole
        hi.tofile(f)
        f.truncate(total * 4)
    indices = np.memmap(fp, dtype=np.int32, mode="r", shape=(total,))
    assert os.stat(fp).st_blocks * 512 < 1 << 20, "file must stay sparse"
    return indptr, indices


def test_runtime_sampler_beyond_2_31(big_csr):
    """The threaded C++ host sampler must read runs past edge 2^31."""
    from legion import runtime
    indptr, indices = big_csr
    ids = np.array([0, N - 1, -1], np.int32)
    out = runtime.sample_neighbors(indptr, indices, ids, DEG, seed=3)
    assert set(out[0]) <= set(range(100, 100 + DEG))
    assert set(out[1]) <= set(range(900, 900 + DEG)), out[1]
    assert (out[2] == -1).all()


def test_numpy_cold_sampler_beyond_2_31(big_csr):
    from legion.cache.topo_cache import host_sample_cold
    indptr, indices = big_csr
    ids = np.array([N - 1, 0], np.int32)
    out = host_sample_cold(indptr, indices, ids, DEG,
                           np.random.default_rng(0))
    assert set(out[0]) <= set(range(900, 900 + DEG))
    assert set(out[1]) <= set(range(100, 100 + DEG))


def test_topo_cache_build_beyond_2_31(big_csr):
    """TopoCache.build gathers hot adjacency across the int32 boundary
    (sub-CSR itself stays int32 — asserted there)."""
    from legion.cache.topo_cache import TopoCache
    indptr, indices = big_csr
    hot = np.array([N - 1, 0], np.int32)
    topo = TopoCache.build(indptr, indices, hot, capacity=2)
    sub = np.asarray(topo.sub_indices)
    assert set(sub[:DEG]) == set(range(100, 100 + DEG))
    assert set(sub[DEG:]) == set(range(900, 900 + DEG))


def test_striped_topo_build_beyond_2_31(big_csr):
    """StripedTopoCache stripes hot runs read from past 2^31."""
    import jax
    from jax.sharding import Mesh
    from legion.cache.striped import StripedTopoCache
    indptr, indices = big_csr
    mesh = Mesh(np.array(jax.devices()[:2]), ("cache",))
    hot = np.array([0, N - 1], np.int32)
    st = StripedTopoCache.build(indptr, indices, hot, capacity=2, mesh=mesh)
    si = np.asarray(st.sub_indices)
    # rank 0 (id 0) on stripe 0, rank 1 (id N-1) on stripe 1
    assert set(si[0][:DEG]) == set(range(100, 100 + DEG))
    assert set(si[1][:DEG]) == set(range(900, 900 + DEG))


def test_presample_hotness_beyond_2_31(big_csr):
    from legion.train.hybrid_driver import presample_hotness_host
    indptr, indices = big_csr
    seeds = np.full((1, 4), -1, np.int32)
    seeds[0, :2] = (0, N - 1)
    node_hot, edge_hot, mx = presample_hotness_host(
        indptr, indices, seeds, (4,), N, seed=0)
    assert edge_hot[0] == 1 and edge_hot[N - 1] == 1
    # the far run's neighbors were actually reached
    assert node_hot[900:900 + DEG].sum() > 0


def test_streaming_generator_roundtrip(tmp_path):
    """The uk-scale generator's output loads, validates, and shows the
    Zipf source skew the cache exists for (small-scale CI twin of
    tools/smoke_uk_scale.py's generation)."""
    from legion.data.synthetic import streaming_power_law_graph
    p = streaming_power_law_graph(
        str(tmp_path / "ds"), num_nodes=5000, avg_degree=7,
        feature_dim=8, num_classes=5, train_num=300, valid_num=50,
        test_num=50, chunk_nodes=1024, log=lambda s: None)
    g = load_dataset(p)
    g.validate()
    assert g.num_nodes == 5000
    meta = json.load(open(os.path.join(p, "meta.json")))
    assert meta["num_edges"] == g.num_edges
    deg = g.degrees()
    assert 5 < deg.mean() < 9
    counts = np.bincount(np.asarray(g.indices), minlength=5000)
    top = np.sort(counts)[::-1]
    assert top[:50].sum() > 3 * g.num_edges / 100, "expected Zipf skew"
    assert len(np.intersect1d(g.train_ids, g.valid_ids)) == 0


# ---------------------------------------------------------------------------
# uk2014/clueweb ARITHMETIC envelope: every integer
# that would see a 47B-edge value, exercised past 2^35 with no giant
# arrays materialized.
# ---------------------------------------------------------------------------


def test_cost_model_arithmetic_at_ukl_magnitudes():
    """Cost-model saved-byte sums at uk2014 hotness magnitudes: per-node
    counters whose cumulative sums pass 2^35 must not wrap (the model
    accumulates in int64) and the capacity split must honor a 38GB
    budget exactly."""
    from legion.cache.cost_model import solve_cost_model
    n = 4096
    # per-node hotness ~1.6e7 over 4096 nodes -> total saved-transaction
    # sums ~6.5e10 > 2^35
    node_hot = np.full(n, 16_000_000, np.int64)
    edge_hot = np.full(n, 16_000_000, np.int64)
    degrees = np.full(n, 60, np.int64)
    budget = 38 << 30                       # reference default cache GB
    cost = solve_cost_model(node_hot, edge_hot, degrees, budget,
                            feat_row_bytes=512, group_size=8)
    # capacities are node counts (here clamped by n), never negative,
    # and the implied bytes never exceed the group budget
    assert 0 <= cost.feat_capacity <= n
    assert 0 <= cost.topo_capacity <= n
    feat_bytes = cost.feat_capacity * 512
    topo_bytes = cost.topo_capacity * (60 * 4 + 8)
    assert feat_bytes + topo_bytes <= budget * 8 * 1.01


def test_seed_plan_and_caps_at_ukl_registry_shapes():
    """Coordinate step math and frontier-cap sizing at the registry's
    largest rows: uk2014 (787.8M nodes) train/eval sets, batch 8000,
    fanout [25,10] — all Python/int64 arithmetic, no wraps."""
    from legion.config import DATASET_REGISTRY
    from legion.sampling.block import frontier_caps
    from legion.sampling.seeds import make_seed_plan
    ukl = DATASET_REGISTRY["UKL"]
    assert ukl.num_edges > 2 ** 35
    # uk-scale training-set shard per 8 chips
    train = [1_000_000 // 8] * 8
    plan = make_seed_plan(train, [16_000] * 8, [16_000] * 8, 8000, 512)
    assert plan.train_steps == (1_000_000 // 8) // 8000
    caps = frontier_caps(8000, (25, 10))
    assert caps[-1] == 8000 * 26 * 11      # combinatorial bound, exact
    # staging/cap sizing arithmetic (striped_hybrid_driver's miss_cap
    # formula) stays in range at those caps
    miss_cap = int(min(caps[-1],
                       (caps[-1] // 16 + 1024 + 127) // 128 * 128))
    assert 0 < miss_cap <= caps[-1]
    # per-chip HBM bytes of a uk2014 hot feature cache at 38GB/8 chips:
    # row count fits int64, exceeds int32 deliberately when multiplied
    rows = (38 << 30) // (ukl.feature_dim * 2)
    assert rows * ukl.feature_dim * 2 == 38 << 30  # no wrap


def test_hotness_histogram_accumulator_headroom():
    """Per-node int32 hotness counters cannot wrap at reference scales:
    the worst per-node count is bounded by presample steps x frontier
    cap (a node is counted at most once per level per step). At the
    uk2014 configuration (125 steps/epoch, 3 levels) that is ~375 <<
    2^31; assert the bound with registry numbers so a future
    presample-length change re-checks it."""
    steps = 1_000_000 // 8000               # full presample epoch
    levels = 3
    worst_per_node = steps * levels
    assert worst_per_node < 2 ** 31


def test_edge_total_accumulator_past_2_31():
    """Epoch edge totals must survive past 2^31 (8-chip DP at the
    reference batch psums ~17M edges/step; a uk-class epoch crosses
    int32). The device programs keep PER-STEP int32 counts and the host
    reduces in int64 (train.loop.sum_edge_counts)."""
    from legion.train.loop import sum_edge_counts
    per_step = np.full(200, 17_000_000, np.int32)    # 3.4e9 > 2^31
    assert sum_edge_counts(per_step) == 200 * 17_000_000
