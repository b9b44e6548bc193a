"""64-bit snowflake IDs: 41-bit ms timestamp | 10-bit worker | 12-bit sequence.

Capability of reference parent_child/snowflake_id.py:5-49 (thread-safe,
monotonic within a worker, sortable by creation time).
"""

from __future__ import annotations

import threading
import time

_EPOCH_MS = 1_577_836_800_000  # 2020-01-01T00:00:00Z


class SnowflakeGenerator:
    TIMESTAMP_BITS = 41
    WORKER_BITS = 10
    SEQUENCE_BITS = 12

    def __init__(self, worker_id: int = 0) -> None:
        assert 0 <= worker_id < (1 << self.WORKER_BITS)
        self.worker_id = worker_id
        self._lock = threading.Lock()
        self._last_ms = -1
        self._seq = 0

    def next_id(self) -> int:
        with self._lock:
            now = int(time.time() * 1000) - _EPOCH_MS
            if now == self._last_ms:
                self._seq = (self._seq + 1) & ((1 << self.SEQUENCE_BITS) - 1)
                if self._seq == 0:
                    while now <= self._last_ms:
                        now = int(time.time() * 1000) - _EPOCH_MS
            else:
                self._seq = 0
            self._last_ms = now
            return (
                (now << (self.WORKER_BITS + self.SEQUENCE_BITS))
                | (self.worker_id << self.SEQUENCE_BITS)
                | self._seq
            )

    @staticmethod
    def timestamp_ms(snowflake: int) -> int:
        return (snowflake >> (SnowflakeGenerator.WORKER_BITS + SnowflakeGenerator.SEQUENCE_BITS)) + _EPOCH_MS
