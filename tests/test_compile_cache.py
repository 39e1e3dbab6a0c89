"""One rule decides JAX's persistent compile cache directory."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys; sys.path.insert(0, ".")
import jax
from legion.utils.compile_cache import configure_compile_cache
before = jax.config.jax_compilation_cache_dir
got = configure_compile_cache()
print(repr(before), repr(got), repr(jax.config.jax_compilation_cache_dir))
"""


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_compile_cache_dir(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    before, got, after = (eval(x) for x in r.stdout.split())
    if env_dir:
        # JAX reads the variable itself; the helper sets nothing
        assert got == str(tmp_path / env_dir) == before == after
    else:
        want = os.path.join(ROOT, ".jax_cache")
        assert before is None and got == after == want
