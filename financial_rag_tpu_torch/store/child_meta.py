"""Host-side child metadata store.

The reference keeps child payloads (parent_id, snippet text, optional LLM
context) inside Chroma point metadata (reference chroma_child_store.py:43-48).
Here the device index stores only vectors; payloads live in SQLite keyed by
child_id, plus document info used by the pre-rerank filters
(reference rag_backend.py:870-1042 uses parent document ext/mtime).
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence


class ChildMetaStore:
    # rows read per query on the serving hot path (~100 candidate children);
    # a per-query SQLite SELECT costs ~1-5ms under thread contention while a
    # dict hit costs ~1us, so rows are mirrored in memory after first read.
    # Bulk-evicted (cleared) at the cap: serving working sets are far below
    # it, and a crude clear beats per-access LRU bookkeeping on this path.
    MEM_CAP = 262_144

    def __init__(self, db_path: str | Path = "children_meta.db") -> None:
        self.db_path = str(db_path)
        self._local = threading.local()
        self._mem: Dict[int, dict] = {}
        # mirror generation: bumped before AND after every write
        # transaction. A reader only populates the mirror if the generation
        # was stable across its SELECT — otherwise a read that raced a
        # re-ingest could cache the PRE-commit row forever (the mirror has
        # no TTL).
        self._gen = 0
        # gen bumps are read-modify-write; two concurrent writers (re-ingest
        # purge racing an upsert) could otherwise lose an increment and make
        # the generation look stable across a write
        self._gen_lock = threading.Lock()
        with self._conn() as c:
            c.execute(
                """CREATE TABLE IF NOT EXISTS children (
                       child_id INTEGER PRIMARY KEY,
                       parent_id INTEGER NOT NULL,
                       document_id TEXT NOT NULL,
                       snippet TEXT NOT NULL,
                       context TEXT,
                       source_path TEXT,
                       source_mtime REAL
                   )"""
            )
            c.execute("CREATE INDEX IF NOT EXISTS idx_children_parent ON children(parent_id)")
            c.execute("CREATE INDEX IF NOT EXISTS idx_children_doc ON children(document_id)")

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

    def upsert_children(self, children: Iterable[dict]) -> int:
        rows = [
            (int(ch["child_id"]), int(ch["parent_id"]), str(ch["document_id"]),
             ch["snippet"], ch.get("context"), ch.get("source_path"), ch.get("source_mtime"))
            for ch in children
        ]
        self._bump_gen()   # entering a write: invalidate in-flight reads
        for r in rows:  # keep the memory mirror coherent with overwrites
            self._mem.pop(r[0], None)
        with self._conn() as c:
            c.executemany(
                """INSERT INTO children(child_id, parent_id, document_id, snippet,
                                        context, source_path, source_mtime)
                   VALUES (?,?,?,?,?,?,?)
                   ON CONFLICT(child_id) DO UPDATE SET
                     parent_id=excluded.parent_id,
                     document_id=excluded.document_id,
                     snippet=excluded.snippet,
                     context=excluded.context,
                     source_path=excluded.source_path,
                     source_mtime=excluded.source_mtime""",
                rows,
            )
        self._bump_gen()   # commit landed: readers may mirror fresh rows again
        # re-pop: a racing reader may have mirrored the OLD row between the
        # first pop and the commit; after this pop any repopulation SELECTs
        # post-commit data
        for r in rows:
            self._mem.pop(r[0], None)
        return len(rows)

    def _bump_gen(self) -> None:
        with self._gen_lock:
            self._gen += 1

    def get_children(self, child_ids: Sequence[int]) -> Dict[int, dict]:
        if not child_ids:
            return {}
        mem = self._mem
        out: Dict[int, dict] = {}
        uniq = []
        for c in child_ids:
            cid = int(c)
            if cid in out:
                continue
            row = mem.get(cid)
            if row is not None:
                out[cid] = row  # shared read-only row (callers copy fields)
            else:
                uniq.append(cid)
        uniq = list(dict.fromkeys(uniq))
        gen0 = self._gen
        # chunk the IN clause to stay under SQLite's variable limit
        for lo in range(0, len(uniq), 500):
            batch = uniq[lo: lo + 500]
            marks = ",".join("?" * len(batch))
            cur = self._conn().execute(
                f"SELECT child_id, parent_id, document_id, snippet, context, "
                f"source_path, source_mtime FROM children WHERE child_id IN ({marks})", batch)
            # mirror rows only when no write overlapped the SELECT (gen
            # stable) — a racing upsert's pop-then-commit window could
            # otherwise be repopulated with the pre-commit row, which the
            # TTL-less mirror would then serve forever
            mirror = self._gen == gen0
            for cid, pid, doc, snippet, context, path, mtime in cur.fetchall():
                row = {"child_id": cid, "parent_id": pid, "document_id": doc,
                       "snippet": snippet, "context": context,
                       "source_path": path, "source_mtime": mtime}
                out[cid] = row
                if mirror and self._gen == gen0:
                    if len(mem) >= self.MEM_CAP:
                        mem.clear()
                    mem[cid] = row
        return out

    def children_of_document(self, document_id: str) -> List[int]:
        cur = self._conn().execute(
            "SELECT child_id FROM children WHERE document_id=?", (document_id,))
        return [r[0] for r in cur.fetchall()]

    def delete_document(self, document_id: str) -> int:
        # same gen discipline as upsert_children: ingest_finish purges old
        # children on EVERY re-ingest / blue-green replace, so this runs on
        # the serving-churn hot path. Clearing the mirror before the DELETE
        # commits without bumping _gen would let a racing get_children
        # repopulate the TTL-less mirror with pre-delete rows — forever.
        self._bump_gen()   # entering a write: invalidate in-flight reads
        self._mem.clear()
        with self._conn() as c:
            cur = c.execute("DELETE FROM children WHERE document_id=?", (document_id,))
            n = cur.rowcount
        self._bump_gen()   # commit landed: readers may mirror fresh rows again
        self._mem.clear()  # drop anything a racing reader mirrored pre-commit
        return n

    def count(self) -> int:
        return self._conn().execute("SELECT COUNT(*) FROM children").fetchone()[0]

    def sample_snippets(self, n: int) -> List[str]:
        """Up to n representative child snippets (rerank warmup uses these
        so compiled sequence buckets match real serving traffic)."""
        cur = self._conn().execute("SELECT snippet FROM children LIMIT ?", (n,))
        return [r[0] for r in cur.fetchall() if r[0]]
