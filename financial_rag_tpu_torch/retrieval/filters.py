"""Pre-rerank result filters: fileType, timeRange and dataSource.

Semantics of reference rag_backend.py:870-1042: fileType maps UI labels to
extension sets (an empty mapping still filters everything out when the UI
sent labels); timeRange supports relative windows and custom ISO ranges on
the source file's mtime. Here filtering uses the child metadata's
source_path/source_mtime captured at ingest (no filesystem walk at query
time).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Optional

TYPE_MAP = {
    "pdf": {".pdf"},
    "word": {".doc", ".docx"},
    "excel": {".xls", ".xlsx", ".csv"},
    "ppt": {".ppt", ".pptx"},
    "txt": {".txt", ".md"},
    "image": {".png", ".jpg", ".jpeg", ".gif", ".tif", ".tiff", ".bmp"},
    "json": {".json"},
    "html": {".html", ".htm"},
    "email": {".eml", ".msg"},
    "compressed": {".zip", ".tar", ".gz", ".rar", ".7z"},
    "page": set(),
}

_RELATIVE_WINDOWS_S = {
    "3days": 3 * 24 * 3600,
    "week": 7 * 24 * 3600,
    "month": 30 * 24 * 3600,
    "3months": 90 * 24 * 3600,
    "6months": 182 * 24 * 3600,
    "year": 365 * 24 * 3600,
    "5years": 5 * 365 * 24 * 3600,
}


def _parse_ts(val: Any) -> Optional[float]:
    if not val:
        return None
    if isinstance(val, (int, float)):
        return float(val)
    if isinstance(val, str):
        try:
            return datetime.fromisoformat(val.replace("Z", "+00:00")).timestamp()
        except ValueError:
            return None
    return None


@dataclass
class ResultFilter:
    allowed_exts: Optional[set] = None   # None = no fileType filter
    min_ts: Optional[float] = None
    max_ts: Optional[float] = None
    label: Optional[str] = None

    # dataSource: every document this framework serves is attributed
    # "Windows Shares" (serving/formatting.py) — same constant the
    # reference UI's first data-source option uses. A dataSource filter
    # excluding it therefore excludes everything; including it is a no-op.
    # (The reference backend ignores dataSource entirely, which made its
    # UI silently lie; here the filter is honored against the attribution
    # the cards actually display.)
    exclude_all: bool = False

    @property
    def active(self) -> bool:
        return (self.allowed_exts is not None or self.min_ts is not None
                or self.max_ts is not None or self.exclude_all)


def build_filter(filters: Optional[dict], now: Optional[float] = None) -> ResultFilter:
    """filters: {'fileType': [labels], 'timeRange': {...}} (UI contract)."""
    f = ResultFilter()
    filters = filters or {}
    now = time.time() if now is None else now

    ft = filters.get("fileType")
    if isinstance(ft, list) and ft:
        exts: set = set()
        for t in ft:
            exts |= TYPE_MAP.get(str(t).lower(), set())
        f.allowed_exts = exts  # possibly empty: filters everything (reference behavior)

    ds = filters.get("dataSource")
    if isinstance(ds, list) and ds and "Windows Shares" not in ds:
        f.exclude_all = True

    tr = filters.get("timeRange") or {}
    if isinstance(tr, dict) and tr:
        f.label = tr.get("label")
        tr_type = (tr.get("type") or "all").lower()
        if tr_type in _RELATIVE_WINDOWS_S:
            f.min_ts = now - _RELATIVE_WINDOWS_S[tr_type]
        elif tr_type == "custom":
            sd_raw, ed_raw = tr.get("startDate"), tr.get("endDate")
            sd, ed = _parse_ts(sd_raw), _parse_ts(ed_raw)
            # a date-only bound ("2026-08-17") parses as MIDNIGHT at the
            # start of that day; whichever value ends up as the UPPER bound
            # must cover the whole day inclusive (start=end=today must match
            # today's documents). Decide date-only-ness per PARSED VALUE
            # before the swap, so a reversed range (startDate later than
            # endDate) extends the bound that actually becomes the upper one
            # — keying off the raw endDate string after the swap extended
            # the wrong side.
            sd_dateonly = isinstance(sd_raw, str) and len(sd_raw.strip()) == 10
            ed_dateonly = isinstance(ed_raw, str) and len(ed_raw.strip()) == 10
            if sd and ed and sd > ed:
                sd, ed = ed, sd
                sd_dateonly, ed_dateonly = ed_dateonly, sd_dateonly
            if ed is not None and ed_dateonly:
                ed += 86400 - 1
            f.min_ts = sd
            f.max_ts = ed or (now if sd else None)
    return f


def passes_filter(f: ResultFilter, source_path: Optional[str], source_mtime: Optional[float]) -> bool:
    if not f.active:
        return True
    if f.exclude_all:
        return False
    if f.allowed_exts is not None:
        if not source_path:
            return False
        if Path(source_path).suffix.lower() not in f.allowed_exts:
            return False
    if f.min_ts is not None or f.max_ts is not None:
        if source_mtime is None:
            return False
        if f.min_ts is not None and source_mtime < f.min_ts:
            return False
        if f.max_ts is not None and source_mtime > f.max_ts:
            return False
    return True
