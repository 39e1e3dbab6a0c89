"""Native host runtime (C++ via ctypes) with numpy fallbacks.

``gnnio.cpp`` is compiled on first use (g++ -O3) into
``_build/libgnnio-<hash of the source>.so`` next to it, a directory git
ignores; a changed source gets a new file name, so a stale build is
never loaded. Every entry point has a numpy fallback so the framework
works without a toolchain; ``native_available()`` says which one runs.
See gnnio.cpp for the reference components each function replaces.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gnnio.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_CXXFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib = None
_build_error = None


def _nthreads() -> int:
    return max(os.cpu_count() or 1, 1)


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_CXXFLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libgnnio-{h.hexdigest()[:12]}.so")


def _build() -> None:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return
    so = _so_path()
    try:
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_CXXFLAGS, _SRC, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.gather_rows_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.sample_neighbors_u32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_int]
        lib.accumulate_hist_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int]
        lib.coo_to_csr.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        for fn in (lib.gather_rows_f32, lib.sample_neighbors_u32,
                   lib.accumulate_hist_i64, lib.coo_to_csr):
            fn.restype = None
        _lib = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _build_error = e
        detail = getattr(e, "stderr", b"") or b""
        print(f"legion.runtime: native build unavailable ({e}) "
              f"{detail.decode(errors='replace')[-400:]}; using numpy "
              "fallbacks", file=sys.stderr)


def native_available() -> bool:
    _build()
    return _lib is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def gather_rows(table: np.ndarray, ids: np.ndarray,
                out: np.ndarray | None = None) -> np.ndarray:
    """out[i] = table[ids[i]] (zeros for ids<0), threaded."""
    _build()
    ids = np.ascontiguousarray(ids, np.int32)
    n, dim = ids.shape[0], table.shape[1]
    if out is None:
        out = np.empty((n, dim), np.float32)
    if _lib is not None and table.dtype == np.float32 and table.flags.c_contiguous:
        _lib.gather_rows_f32(_ptr(out), _ptr(table), _ptr(ids),
                             n, dim, table.shape[0], _nthreads())
        return out
    safe = np.clip(ids, 0, table.shape[0] - 1)
    np.take(table, safe, axis=0, out=out)
    out[ids < 0] = 0.0
    return out


def sample_neighbors(indptr: np.ndarray, indices: np.ndarray,
                     ids: np.ndarray, fanout: int, seed: int) -> np.ndarray:
    """Host uniform-with-replacement sampling; -1 sentinel semantics
    matching the device sampler."""
    _build()
    ids = np.ascontiguousarray(ids, np.int32)
    n = ids.shape[0]
    if (_lib is not None and indptr.dtype == np.int64
            and indices.dtype == np.int32 and indptr.flags.c_contiguous
            and indices.flags.c_contiguous):
        out = np.empty((n, fanout), np.int32)
        _lib.sample_neighbors_u32(_ptr(out), _ptr(np.ascontiguousarray(indptr)),
                                  _ptr(np.ascontiguousarray(indices)),
                                  _ptr(ids), n, fanout,
                                  ctypes.c_uint64(seed), _nthreads())
        return out
    from legion.cache.topo_cache import host_sample_cold
    return host_sample_cold(indptr, indices, ids, fanout,
                            np.random.default_rng(seed))


def accumulate_hist(hist: np.ndarray, ids: np.ndarray) -> None:
    """hist[v] += count of v in ids (ids<0 skipped), in place."""
    _build()
    ids = np.ascontiguousarray(ids.reshape(-1), np.int32)
    if _lib is not None and hist.dtype == np.int64 and hist.flags.c_contiguous:
        _lib.accumulate_hist_i64(_ptr(hist), _ptr(ids), ids.shape[0],
                                 hist.shape[0], _nthreads())
        return
    v = ids[ids >= 0]
    np.add.at(hist, v, 1)


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """(indptr int64, indices int32) from COO, native counting sort."""
    _build()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    e = src.shape[0]
    if _lib is not None:
        indptr = np.zeros(num_nodes + 1, np.int64)
        indices = np.empty(e, np.int32)
        _lib.coo_to_csr(_ptr(src), _ptr(dst), e, num_nodes,
                        _ptr(indptr), _ptr(indices))
        return indptr, indices
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=indptr[1:])
    return indptr, src[order]
