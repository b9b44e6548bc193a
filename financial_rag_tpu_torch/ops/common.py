"""Shared integer helpers for the kernel wrappers."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
