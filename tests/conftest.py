"""Test harness: force an 8-device virtual CPU mesh.

Multi-chip hardware is not available in CI; all sharding/collective tests
run on XLA's host-platform device virtualization (SURVEY.md §4: the
multi-host-simulated mesh standing in for distributed tests).
"""

import os

# Force-set: tests must not depend on, or contend for, an accelerator.
# LEGION_TEST_GPU=1 leaves the platform alone, for the `gpu`-marked tests
# on the card (tests/test_gpu.py).
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
if not os.environ.get("LEGION_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not os.environ.get("LEGION_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from legion.data.synthetic import chain_graph, random_power_law_graph  # noqa: E402


@pytest.fixture(scope="session")
def small_graph():
    return random_power_law_graph(num_nodes=2000, avg_degree=8,
                                  feature_dim=32, num_classes=7, seed=1)


@pytest.fixture(scope="session")
def tiny_chain():
    return chain_graph(num_nodes=8, feature_dim=4)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
