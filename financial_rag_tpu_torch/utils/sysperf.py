"""System-performance recorder.

Counterpart of the reference's periodic system monitor
(reference feedback_database.py:673-694: a loop recording cpu/mem/qpm/
error-rate into the `system_performance` table). The reference uses psutil;
here cpu comes from os.times() deltas and memory from /proc (resource
ru_maxrss fallback), so there is no extra dependency.

The serving layer calls record_request() per /search and /search-stream
request; a daemon thread snapshots into FeedbackDatabase every interval_s.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

from financial_rag_tpu_torch.utils import get_logger

log = get_logger("utils.sysperf")

_WINDOW_S = 600.0  # error-rate window; qpm always uses the last 60s


def _mem_pct() -> float:
    """Process RSS as a percentage of total system memory."""
    try:
        with open("/proc/self/status") as f:
            rss_kb = next(int(line.split()[1]) for line in f
                          if line.startswith("VmRSS:"))
        with open("/proc/meminfo") as f:
            total_kb = next(int(line.split()[1]) for line in f
                            if line.startswith("MemTotal:"))
        return 100.0 * rss_kb / max(total_kb, 1)
    except (OSError, StopIteration, ValueError, IndexError):
        try:
            import resource

            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return 100.0 * rss_kb / max(os.sysconf("SC_PHYS_PAGES")
                                        * os.sysconf("SC_PAGE_SIZE") / 1024, 1)
        except (OSError, ValueError):
            return 0.0


class SystemPerformanceRecorder:
    def __init__(self, feedback_db=None, interval_s: float = 60.0) -> None:
        self.db = feedback_db
        self.interval_s = interval_s
        self._events: deque = deque()           # (ts, ok)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        t = os.times()
        self._cpu_mark = (time.monotonic(), t.user + t.system)

    # ------------------------------------------------------------- requests

    def record_request(self, ok: bool = True) -> None:
        now = time.time()
        with self._lock:
            self._events.append((now, ok))
            cutoff = now - _WINDOW_S
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        now = time.time()
        with self._lock:
            recent = [(ts, ok) for ts, ok in self._events if ts >= now - _WINDOW_S]
        last_min = [ok for ts, ok in recent if ts >= now - 60.0]
        errors = sum(1 for _, ok in recent if not ok)

        mono, cpu = time.monotonic(), os.times()
        cpu_total = cpu.user + cpu.system
        dt = mono - self._cpu_mark[0]
        cpu_pct = 0.0
        if dt > 0:
            cpu_pct = 100.0 * (cpu_total - self._cpu_mark[1]) / dt / max(os.cpu_count() or 1, 1)
        self._cpu_mark = (mono, cpu_total)

        return {
            "cpu_pct": round(cpu_pct, 2),
            "mem_pct": round(_mem_pct(), 2),
            "queries_per_minute": float(len(last_min)),
            "error_rate": round(errors / len(recent), 4) if recent else 0.0,
        }

    def record_now(self) -> dict:
        row = self.snapshot()
        if self.db is not None:
            self.db.record_system_performance(**row)
        return row

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.record_now()
                except Exception:  # noqa: BLE001 — monitoring must not kill serving
                    log.exception("system-performance snapshot failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sysperf-recorder")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
