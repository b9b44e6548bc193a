"""Incremental processing ledger.

Capability of reference api_server.py:67-134,339-364: per-source-document
state (size, mtime, sha256, stage flags) persisted as JSON, with change
detection driving re-extraction / re-chunking / re-embedding — the
framework's checkpoint/resume analog (SURVEY.md §5.4).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional


@dataclass
class DocumentState:
    path: str
    size: int = 0
    mtime: float = 0.0
    sha256: str = ""
    extracted: bool = False
    extracted_path: Optional[str] = None
    chunked: bool = False
    embedded: bool = False
    last_processed: Optional[float] = None
    error: Optional[str] = None
    # a CHANGED document's old content must be purged before its new
    # content commits (blue/green replace). The flag persists so a failed
    # attempt can't lose the purge: refresh_entry records the new sha at
    # begin-time, after which has_changed() is False — without this flag a
    # retry would re-ingest while the superseded version's children stay
    # live forever.
    pending_purge: bool = False


def file_sha256(path: str | Path, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_size)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


class ProcessingLedger:
    def __init__(self, state_path: str | Path = ".processing_state.json") -> None:
        self.state_path = Path(state_path)
        self._lock = threading.Lock()
        self.states: Dict[str, DocumentState] = {}
        # {doc_id, child_ids} records for purges NOT yet captured by a
        # successful index checkpoint. remove_missing deletes the ledger
        # entry outright, so without this a failed checkpoint (or a crash)
        # on a deletion-heavy sweep leaves no retry obligation — a restart
        # loads the stale checkpoint and resurrects the purged vectors as
        # metadata-less ghosts that no later sweep re-purges (the SQLite
        # metadata deletion commits immediately, so the doc->children
        # lookup the purge needs is gone; child_ids preserves it).
        self._purge_tombstones: List[dict] = []
        self.load()

    # --------------------------------------------------------- persistence

    def load(self) -> None:
        if not self.state_path.exists():
            return
        try:
            raw = json.loads(self.state_path.read_text())
            if isinstance(raw, dict) and raw.get("__format__") == 2:
                self.states = {k: DocumentState(**v)
                               for k, v in raw["states"].items()}
                self._purge_tombstones = [
                    t if isinstance(t, dict)
                    else {"doc_id": str(t), "child_ids": []}
                    for t in raw.get("purge_tombstones", [])]
            else:  # legacy format: flat {path: state}
                self.states = {k: DocumentState(**v) for k, v in raw.items()}
                self._purge_tombstones = []
        except (json.JSONDecodeError, TypeError, KeyError):
            self.states = {}
            self._purge_tombstones = []

    def save(self) -> None:
        with self._lock:
            tmp = self.state_path.with_suffix(".tmp")
            tmp.write_text(json.dumps({
                "__format__": 2,
                "states": {k: dataclasses.asdict(v) for k, v in self.states.items()},
                "purge_tombstones": list(self._purge_tombstones),
            }, indent=2))
            tmp.replace(self.state_path)

    # ----------------------------------------------------- purge tombstones

    def add_purge_tombstone(self, doc_id: str,
                            child_ids: Optional[List[int]] = None) -> None:
        """Record that doc_id's vectors were purged in memory but the purge
        is not yet durable (no index checkpoint has succeeded since).
        ``child_ids`` carries the purged ids: the SQLite metadata deletion
        commits immediately while the index purge only lives until the next
        checkpoint, so after a crash the doc->children lookup is GONE and
        the replayed purge must delete the ghost vectors by id."""
        with self._lock:
            for t in self._purge_tombstones:
                if t["doc_id"] == doc_id:
                    if child_ids:
                        merged = set(t.get("child_ids") or []) | set(
                            int(c) for c in child_ids)
                        t["child_ids"] = sorted(merged)
                    return
            self._purge_tombstones.append(
                {"doc_id": doc_id,
                 "child_ids": sorted(int(c) for c in (child_ids or []))})

    def purge_tombstones(self) -> List[dict]:
        with self._lock:
            return [dict(t) for t in self._purge_tombstones]

    def clear_purge_tombstones(self) -> None:
        """Call after a SUCCESSFUL index checkpoint: the purges are durable."""
        with self._lock:
            self._purge_tombstones.clear()

    # -------------------------------------------------------------- change

    def scan(self, source_dir: str | Path, exts: Optional[set] = None) -> List[str]:
        """Walk source_dir; returns sorted list of document paths found."""
        source_dir = Path(source_dir)
        if not source_dir.is_dir():
            return []
        found = []
        for p in sorted(source_dir.rglob("*")):
            if not p.is_file():
                continue
            if exts and p.suffix.lower() not in exts:
                continue
            found.append(str(p))
        return found

    def has_changed(self, path: str) -> bool:
        """New file, or size/mtime changed (sha checked only then: cheap-first,
        reference api_server.py:111-134)."""
        st = self.states.get(path)
        p = Path(path)
        if st is None:
            return True
        stat = p.stat()
        if stat.st_size == st.size and abs(stat.st_mtime - st.mtime) < 1e-6:
            return False
        return file_sha256(path) != st.sha256

    def needs_processing(self, path: str) -> bool:
        st = self.states.get(path)
        if st is None or self.has_changed(path):
            return True
        return not (st.extracted and st.chunked and st.embedded)

    def refresh_entry(self, path: str) -> DocumentState:
        """(Re)stat + hash a file into a fresh state entry. pending_purge
        carries over — it reflects unfinished work, not file identity."""
        stat = Path(path).stat()
        st = DocumentState(path=path, size=stat.st_size, mtime=stat.st_mtime,
                           sha256=file_sha256(path))
        with self._lock:
            old = self.states.get(path)
            if old is not None:
                st.pending_purge = old.pending_purge
            self.states[path] = st
        return st

    def mark(self, path: str, **updates) -> None:
        with self._lock:
            st = self.states.get(path)
            if st is None:
                return
            for k, v in updates.items():
                setattr(st, k, v)
            st.last_processed = time.time()

    def remove_missing(self, existing_paths: List[str]) -> List[str]:
        """Drop ledger entries whose source files disappeared; returns them."""
        existing = set(existing_paths)
        with self._lock:
            gone = [p for p in self.states if p not in existing]
            for p in gone:
                del self.states[p]
        return gone

    def summary(self) -> dict:
        total = len(self.states)
        return {
            "total": total,
            "extracted": sum(1 for s in self.states.values() if s.extracted),
            "chunked": sum(1 for s in self.states.values() if s.chunked),
            "embedded": sum(1 for s in self.states.values() if s.embedded),
            "errors": sum(1 for s in self.states.values() if s.error),
        }
