"""Sliding-window rate limiter (capability of reference utils.py:138-165)."""

from __future__ import annotations

import threading
import time
from collections import deque


class RateLimiter:
    def __init__(self, max_calls: int, window_s: float) -> None:
        self.max_calls = max_calls
        self.window_s = window_s
        self._calls: deque = deque()
        self._lock = threading.Lock()

    def allow(self, now: float = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            cutoff = now - self.window_s
            while self._calls and self._calls[0] <= cutoff:
                self._calls.popleft()
            if len(self._calls) >= self.max_calls:
                return False
            self._calls.append(now)
            return True

    def wait(self, poll_s: float = 0.05) -> None:
        while not self.allow():
            time.sleep(poll_s)
