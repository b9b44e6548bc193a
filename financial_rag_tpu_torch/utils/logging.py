"""Uniform logging (capability of reference utils.py:5-27).

Unlike the reference (which logs to stdout), the handler writes to STDERR:
several CLIs in this repo (bench.py, scripts/bench_*.py) print one
machine-readable JSON line on stdout for the driver/callers to parse, and
an INFO line (e.g. the IVF autotuner's sweep report) must never corrupt
that stream."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s | %(message)s"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    try:
        handler.stream.reconfigure(encoding="utf-8")
    except Exception:
        pass
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger("financial_rag_tpu_torch")
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("financial_rag_tpu_torch"):
        name = f"financial_rag_tpu_torch.{name}"
    return logging.getLogger(name)
