"""Structured logging.

The reference logs with raw ``std::cout``/``printf`` scattered across
the server (``src/GPUGraphStore.cu:200-223``, ``src/GPUCache.cu:762-765``)
and bare ``print`` on the client — no levels, no structure (SURVEY.md
§5). Here: one stdlib logger namespace plus a one-line-JSON metrics
emitter that downstream tooling can parse.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "legion") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("LEGION_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger


def log_metrics(record: Dict[str, Any], stream=None) -> None:
    """Emit one JSON line of metrics (machine-parseable run log)."""
    stream = stream or sys.stderr
    rec = {"ts": round(time.time(), 3), **record}
    print(json.dumps(rec), file=stream, flush=True)


def eval_labels(cfg) -> "tuple[str, str]":
    """(valid label, test label) for driver epoch lines. For ``lp_sage``
    the eval figure is a mean -logsigmoid loss (LOWER is better,
    ``pytorch_extension/lp_sage.py:86-97``), not an accuracy — labeling
    it "Val Acc" misreads a falling curve as degradation."""
    if cfg.model.arch == "lp_sage":
        return "Val LP-loss", "LP-loss on test data"
    return "Val Acc", "Accuracy on test data"
