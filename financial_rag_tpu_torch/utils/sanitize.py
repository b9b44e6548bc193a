"""Query validation / sanitization (capability of reference utils.py:246-268)."""

from __future__ import annotations

import re

MAX_QUERY_LEN = 1000

_SCRIPT_PATTERNS = [
    re.compile(r"<\s*script[^>]*>.*?<\s*/\s*script\s*>", re.IGNORECASE | re.DOTALL),
    re.compile(r"<\s*script[^>]*>", re.IGNORECASE),
    re.compile(r"javascript\s*:", re.IGNORECASE),
    re.compile(r"on\w+\s*=", re.IGNORECASE),
    re.compile(r"data\s*:\s*text/html", re.IGNORECASE),
]


class QueryValidationError(ValueError):
    pass


def validate_and_sanitize_query(query: object, max_len: int = MAX_QUERY_LEN) -> str:
    """Return a cleaned query string or raise QueryValidationError."""
    if not isinstance(query, str):
        raise QueryValidationError("query must be a string")
    q = query.strip()
    if not q:
        raise QueryValidationError("query must not be empty")
    if len(q) > max_len:
        raise QueryValidationError(f"query exceeds {max_len} characters")
    for pat in _SCRIPT_PATTERNS:
        q = pat.sub(" ", q)
    # collapse whitespace and strip control characters
    q = "".join(ch for ch in q if ch == "\n" or ch == "\t" or ord(ch) >= 0x20)
    q = re.sub(r"\s+", " ", q).strip()
    if not q:
        raise QueryValidationError("query empty after sanitization")
    return q
