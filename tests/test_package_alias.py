"""The package's former name stays importable for one release: it warns
and resolves to the very modules of ``legion``."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIASES = sorted(
    d for d in os.listdir(ROOT)
    if os.path.isfile(os.path.join(ROOT, d, "__init__.py"))
    and '_NEW = "legion"' in open(os.path.join(ROOT, d,
                                               "__init__.py")).read())

CHECK = """
import sys, warnings
old = sys.argv[1]
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    pkg = __import__(old)
assert any(issubclass(x.category, DeprecationWarning) for x in w), w
import importlib
import legion
import legion.cache.hotness
assert pkg is legion
mod = importlib.import_module(old + ".cache.hotness")
assert mod is legion.cache.hotness
assert mod.__spec__.name == "legion.cache.hotness"
sub = importlib.import_module(old + ".sampling.sampler")
from legion.sampling.sampler import DeviceGraph
assert sub.DeviceGraph is DeviceGraph
exec(f"from {old}.models import build_model")
from legion.models import build_model as b2
assert build_model is b2
print("ok")
"""


def test_one_alias_package():
    assert len(ALIASES) == 1, ALIASES


@pytest.mark.parametrize("old", ALIASES)
def test_alias_resolves_to_legion_modules(old):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", CHECK, old], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
