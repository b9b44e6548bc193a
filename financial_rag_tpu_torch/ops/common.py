"""Shared helpers for the kernel wrappers: integer arithmetic, and the lock
that guards their launch counters (a count's ``+= 1`` is a read, an add and
a write, and the serving batchers launch from several threads at once)."""

from __future__ import annotations

import threading

LAUNCH_LOCK = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
