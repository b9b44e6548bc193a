"""Host-side SQLite parent store.

Parents are the LLM context units of the two-tier data model; they stay
host-side (SQLite is not a TPU concern — SURVEY.md §2.4). Schema and
semantics of reference parent_child/parent_store.py:19-73, including
order-preserving get_parents_by_ids.
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence


class ParentStore:
    def __init__(self, db_path: str | Path = "parents.db") -> None:
        self.db_path = str(db_path)
        self._local = threading.local()
        with self._conn() as c:
            c.execute(
                """CREATE TABLE IF NOT EXISTS parents (
                       parent_id INTEGER PRIMARY KEY,
                       document_id TEXT NOT NULL,
                       page_start INTEGER,
                       page_end INTEGER,
                       content TEXT NOT NULL
                   )"""
            )
            c.execute("CREATE INDEX IF NOT EXISTS idx_parents_doc ON parents(document_id)")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path)
            conn.execute("PRAGMA journal_mode=WAL")
            # WAL + NORMAL: fsync per checkpoint, not per commit — a crash
            # loses at most the tail transactions, never corrupts; ingest
            # commits were ~30% of host time at FULL
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def upsert_parents(self, parents: Iterable[dict]) -> int:
        rows = [
            (int(p["parent_id"]), str(p["document_id"]),
             p.get("page_start"), p.get("page_end"), p["content"])
            for p in parents
        ]
        with self._conn() as c:
            c.executemany(
                """INSERT INTO parents(parent_id, document_id, page_start, page_end, content)
                   VALUES (?,?,?,?,?)
                   ON CONFLICT(parent_id) DO UPDATE SET
                     document_id=excluded.document_id,
                     page_start=excluded.page_start,
                     page_end=excluded.page_end,
                     content=excluded.content""",
                rows,
            )
        return len(rows)

    def get_parents_by_ids(self, parent_ids: Sequence[int]) -> List[dict]:
        """Fetch parents preserving the input id order; missing ids skipped."""
        if not parent_ids:
            return []
        uniq = list(dict.fromkeys(int(p) for p in parent_ids))
        marks = ",".join("?" * len(uniq))
        cur = self._conn().execute(
            f"SELECT parent_id, document_id, page_start, page_end, content "
            f"FROM parents WHERE parent_id IN ({marks})", uniq)
        by_id: Dict[int, dict] = {}
        for pid, doc, ps, pe, content in cur.fetchall():
            by_id[pid] = {"parent_id": pid, "document_id": doc,
                          "page_start": ps, "page_end": pe, "content": content}
        return [by_id[p] for p in uniq if p in by_id]

    def delete_document(self, document_id: str) -> int:
        with self._conn() as c:
            cur = c.execute("DELETE FROM parents WHERE document_id=?", (document_id,))
            return cur.rowcount

    def count(self) -> int:
        return self._conn().execute("SELECT COUNT(*) FROM parents").fetchone()[0]

    def document_ids(self) -> List[str]:
        cur = self._conn().execute("SELECT DISTINCT document_id FROM parents")
        return [r[0] for r in cur.fetchall()]
