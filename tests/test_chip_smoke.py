"""chip_smoke.py on the CPU: without a GPU it fails before printing a
result, alone it fails, and its phase functions pass at a tiny size
(the same functions run at real widths on the card)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_needs_a_gpu():
    r = _run(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def tiny_products(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("smoke") / "products")
    return path, cs.smoke_dataset(path, 20_000, 50, 512, seed=0)


def test_parity_phase_tiny(tiny_products):
    """Sampler ids (ids above 2^24 included), dedup, aggregation and
    model parity at a tiny size."""
    _, data = tiny_products
    cs.parity_phase(data, width=2048, high_ids=(1 << 24) + (1 << 16),
                    high_rows=4000, batch=256, model_batch=64, hidden=32)


@pytest.mark.parametrize("name", sorted(cs.MAIN_RUNS))
def test_main_path_run_tiny(tiny_products, tmp_path, name):
    path, _ = tiny_products
    out = cs.main_path_run(name, path, str(tmp_path), *cs.MAIN_RUNS[name],
                           batch=256, hidden=32, lr=0.03)
    assert out["checkpoint_restored_exact"] and out["steps"] > 0


def test_four_card_phase_tiny(tmp_path):
    """DP, striped cache and striped hybrid through train.main on four
    virtual CPU devices: each one's one-step f32 epoch checked against
    its one-device recomputation, then a short bf16 epoch each."""
    cs.four_card_phase(str(tmp_path), num_nodes=20_000, batch=128,
                       hidden=32, flagship_nodes=20_000, flagship_degree=20,
                       flagship_batch=64, flagship_steps=4, lr=0.03)


def test_check_fails_loudly():
    with pytest.raises(cs.CheckFailed, match="boom"):
        cs.check(False, "boom")
