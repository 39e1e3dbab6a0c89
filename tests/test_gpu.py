"""Checks that need the card: the chip_smoke parity functions at real
widths on an NVIDIA GPU, where an f32 dot may run in TF32 and
scatter-adds use atomics. They skip on other platforms; on the card:

    LEGION_TEST_GPU=1 python -m pytest -m gpu tests/

(chip_smoke.py runs the same functions as its parity phase.)
"""

import jax
import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX runs on {dev.platform})")
    return dev


@pytest.fixture(scope="module")
def products():
    from legion.data.synthetic import bench_graph
    return bench_graph(num_nodes=500_000, avg_degree=50)


def test_sampler_ids_exact_on_gpu(gpu, products):
    indptr = np.asarray(products.indptr)
    rows = np.flatnonzero(np.diff(indptr) > 0).astype(np.int32)
    cs.check_sampler_ids(indptr, np.asarray(products.indices), rows,
                         ("lined", "aligned", "windowed"), 141_952, 10, 0,
                         "products")
    hi = cs.high_id_graph((1 << 24) + (1 << 20), 400_000, 0)
    cs.check_sampler_ids(hi[0], hi[1], hi[2], ("aligned", "windowed"),
                         141_952, 10, 0, "ids above 2^24")


def test_aggregation_on_gpu(gpu):
    cs.check_aggregation(141_952, 10, 8000, 25, 141_952, 128, 0)


def test_models_on_gpu(gpu, products):
    from legion.sampling.sampler import DeviceGraph
    g = DeviceGraph.from_host(products.indptr, products.indices)
    seeds = np.random.default_rng(0).choice(
        np.asarray(products.train_ids), 1024, replace=False)
    cs.check_models(g, np.asarray(products.features),
                    seeds.astype(np.int32), 256, 47, 0)
