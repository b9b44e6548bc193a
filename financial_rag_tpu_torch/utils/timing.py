"""Wall-time instrumentation (capability of reference utils.py:34-135).

A decorator + context manager that records labeled block durations,
classifies them fast/medium/slow, and can emit a percentage summary.
Additionally integrates with torch.profiler.record_function so blocks show
up as labelled ranges in a torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from typing import Dict, List

import torch


class TimingLogger:
    FAST_S = 0.1
    SLOW_S = 2.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: Dict[str, List[float]] = defaultdict(list)

    def record(self, label: str, seconds: float) -> None:
        with self._lock:
            self._records[label].append(seconds)

    @contextlib.contextmanager
    def block(self, label: str):
        ctx = torch.profiler.record_function(label)
        start = time.perf_counter()
        with ctx:
            yield
        self.record(label, time.perf_counter() - start)

    def function(self, label: str = None):
        def deco(fn):
            lbl = label or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.block(lbl):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    @staticmethod
    def classify(seconds: float) -> str:
        if seconds < TimingLogger.FAST_S:
            return "fast"
        if seconds < TimingLogger.SLOW_S:
            return "medium"
        return "slow"

    def summary(self) -> dict:
        with self._lock:
            totals = {k: sum(v) for k, v in self._records.items()}
            grand = sum(totals.values()) or 1.0
            return {
                k: {
                    "total_s": round(t, 6),
                    "count": len(self._records[k]),
                    "mean_s": round(t / len(self._records[k]), 6),
                    "pct": round(100.0 * t / grand, 2),
                    "class": self.classify(t / len(self._records[k])),
                }
                for k, t in sorted(totals.items(), key=lambda kv: -kv[1])
            }

    def reset(self) -> None:
        with self._lock:
            self._records.clear()


GLOBAL_TIMER = TimingLogger()
time_block = GLOBAL_TIMER.block
time_function = GLOBAL_TIMER.function
