"""Quantitative communication accounting.

The reference measures cross-link traffic with Intel PCM's PCIe
transaction counters (``src/Server.cu:84-100``); here every collective's
volume is a CLOSED FORM of the static shapes, so the accounting can be
exact and checkable: the formulas below are asserted against the
collectives actually present in the COMPILED HLO of each program
(tests/test_comm_accounting.py) — if a code change silently adds or
inflates a collective, the assertion names it.

Two layers: ``hlo_collective_bytes`` reports the raw OUTPUT bytes of
every collective op found in compiled HLO (exactly assertable against
the closed forms), and ``link_bytes`` converts those to approximate
per-chip ring traffic for cross-strategy comparisons (the exact
exchange vs the psum exchange's K x volume).
"""

from __future__ import annotations

import re
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s*"
    r"(all-to-all|all-gather|reduce-scatter|all-reduce|collective-permute)"
    r"(?:-start)?\(")


def _shape_bytes(shapes: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shapes):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def hlo_collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum the per-execution byte volume of every collective in a
    compiled HLO module, per chip, keyed by op kind (the shapes printed
    on a collective are its OUTPUT = its input for these ops, modulo
    all-gather whose output is K x input — the convention above is
    applied by the caller-side formulas, not here: this function
    reports raw output bytes per op kind)."""
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        # async pairs (op-start/op-done) would double count: the -start
        # carries the shapes; plain ops appear once
        key = m.group(2)
        out[key] = out.get(key, 0) + _shape_bytes(m.group(1))
    return out


def compiled_collective_bytes(compiled) -> Dict[str, int]:
    """hlo_collective_bytes over a jax ``lowered.compile()`` result."""
    return hlo_collective_bytes(compiled.as_text())


# ---------------------------------------------------------------------------
# Closed-form per-step volumes (bytes per chip per step)
# ---------------------------------------------------------------------------

def exact_exchange_bytes(m: int, k: int, d: int, itemsize: int = 4,
                         cap: int | None = None,
                         payload: bool = False) -> Dict[str, int]:
    """sharded_row_fetch / StripedTopoCache.sample_hot (exact route-by-
    owner exchange): one (k, cap) id all_to_all (+ one payload a2a when
    draws ride along) and one (k, cap, d) response all_to_all. Total
    ~ owner_cap_slack x the requested rows — vs k x for the psum
    exchange (the headline reduction this accounting exists to pin)."""
    from legion.parallel.feature_exchange import owner_cap
    cap = cap if cap is not None else owner_cap(m, k)
    ids = k * cap * 4 * (2 if payload else 1)
    rows = k * cap * d * itemsize
    return {"all-to-all": ids + rows}


def psum_exchange_bytes(m: int, k: int, d: int,
                        itemsize: int = 4) -> Dict[str, int]:
    """sharded_row_fetch_psum (v1): all_gather of every chip's ids +
    reduce-scatter of the full (k*m, d) one-hot response. Values are
    HLO OUTPUT bytes (what hlo_collective_bytes reports): the
    reduce-scatter OUTPUT is (m, d) but its INPUT (k*m, d) all crosses
    links — use link_bytes() for traffic comparisons."""
    return {"all-gather": k * m * 4, "reduce-scatter": m * d * itemsize}


def halo_exact_fetch_bytes(dist_caps, d: int,
                           itemsize: int = 4) -> Dict[str, int]:
    """partitioned_row_fetch_exact: per ring distance r one forward
    ppermute of (C_r,) int32 request ids and one backward ppermute of
    (C_r, D) rows — each requested row crosses the network ONCE, total
    ~slack x the requested remote rows (vs K x for the psum oracle).
    Self-requests never appear in any collective."""
    s = int(sum(dist_caps))
    return {"collective-permute": s * 4 + s * d * itemsize}


def halo_exact_hop_bytes(dist_caps, fanout: int) -> Dict[str, int]:
    """partitioned_sample_hop_exact: per distance one forward ppermute
    of (C_r, 2) int32 (id + global draw-grid index) and one backward
    ppermute of (C_r, fanout) int32 draws."""
    s = int(sum(dist_caps))
    return {"collective-permute": s * 8 + s * fanout * 4}


def link_bytes(hlo_out_bytes: Dict[str, int], k: int) -> int:
    """Approximate per-chip link traffic from HLO output bytes on a
    K-chip ring: all-gather output is K x its input and ~(K-1)/K of it
    crossed links; a reduce-scatter's INPUT (= K x output) crosses;
    all-to-all moves (K-1)/K of itself; all-reduce ~2 x input."""
    f = {
        "all-gather": (k - 1) / k,
        "reduce-scatter": k - 1,          # input = k x output
        "all-to-all": (k - 1) / k,
        "all-reduce": 2 * (k - 1) / k,
        "collective-permute": 1.0,
    }
    return int(sum(v * f.get(op, 1.0) for op, v in hlo_out_bytes.items()))


def grad_allreduce_bytes(param_count: int, itemsize: int = 4) -> int:
    """DP gradient pmean (DDP analog): 2 x param bytes on a ring."""
    return 2 * param_count * itemsize


def param_bytes(params) -> int:
    import jax
    return sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(params))
