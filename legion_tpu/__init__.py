"""Former name of the ``legion`` package, kept as an alias for one release.

Importing this package, or any module under it, warns once and yields
the ``legion`` module of the same path: the very same module objects, so
classes, registries and jitted functions are shared with code that
imports ``legion`` directly.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

_NEW = "legion"
_OLD = __name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.x.y`` to ``legion.x.y``, importing it if need be."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        # the import system stamps the alias spec on the module it is
        # handed; exec_module puts the module's own spec back
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        module.__spec__ = self._specs.pop(module.__spec__.name)


warnings.warn(f"the {_OLD!r} package is now {_NEW!r}; import {_NEW!r}",
              DeprecationWarning, stacklevel=2)
sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = importlib.import_module(_NEW)
