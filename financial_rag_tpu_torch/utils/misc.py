"""Small numeric + quality helpers (capability of reference utils.py:323-346)."""

from __future__ import annotations

import re
from typing import Iterable, Sequence


def safe_mean(values: Sequence[float], default: float = 0.0) -> float:
    vals = [v for v in values if v is not None]
    return sum(vals) / len(vals) if vals else default


def safe_divide(num: float, den: float, default: float = 0.0) -> float:
    return num / den if den else default


_WORD_RE = re.compile(r"[a-z0-9]+")


def assess_chunk_quality(query: str, chunk_text: str) -> float:
    """Word-overlap relevance heuristic in [0, 1]."""
    q_words = set(_WORD_RE.findall(query.lower()))
    c_words = set(_WORD_RE.findall(chunk_text.lower()))
    if not q_words or not c_words:
        return 0.0
    overlap = len(q_words & c_words)
    return min(1.0, overlap / max(1, len(q_words)))
