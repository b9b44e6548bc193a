"""Feedback / analytics / result-cache database.

Capability of reference feedback_database.py:343-694 (tables query_feedback,
query_cache, analytics_summary, system_performance; feedback storage;
result cache with TTL + hit counting; performance summaries) and a working
subset of its AdvancedAnalytics (temporal patterns, keyword frequency,
anomaly detection, optimization suggestions — feedback_database.py:25-328).

Implementation note: the reference uses aiosqlite + a per-request asyncio
loop purely to dodge Flask threading; here plain sqlite3 with per-thread
connections serves the same capability without the event-loop machinery.
"""

from __future__ import annotations

import json
import math
import sqlite3
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional


class FeedbackDatabase:
    def __init__(self, db_path: str | Path = "feedback.db", cache_ttl_s: float = 3600.0) -> None:
        self.db_path = str(db_path)
        self.cache_ttl_s = cache_ttl_s
        self._local = threading.local()
        # In-memory key mirror of query_cache: cache_get sits on the serving
        # hot path and a per-query SQLite SELECT costs ~2-3ms under thread
        # contention (profiled); a dict miss costs ~1us. SQLite stays the
        # durable store — the mirror only answers MISSES without I/O; hits
        # (rare, and worth a 46ms saved query) still read/update SQLite.
        self._cache_keys: Dict[str, float] = {}
        # Deferred batched writes: the serving hot path records a feedback
        # row + a cache row per query; committed individually that is 2
        # SQLite transactions (+ a result-JSON encode) per query of
        # GIL/fsync time (profiled ~5-20ms under load). defer_* append to a
        # buffer; one writer thread commits the batch in a single
        # transaction every FLUSH_INTERVAL_S (or on flush_writes(), which
        # every read path calls first so reads always see prior writes).
        self._pending: List[tuple] = []
        self._plock = threading.Lock()
        # serializes whole flushes: without it a reader's flush_writes could
        # see _pending empty and return while the writer thread holds
        # popped-but-uncommitted ops — its SELECT would then miss completed
        # queries despite the "reads observe deferred writes" contract
        self._flush_lock = threading.Lock()
        self._cache_pending: Dict[str, dict] = {}
        self._writer_started = False
        self._init_schema()
        # mirror keys persisted by prior runs (hash+timestamp only — results
        # stay on disk until a hit actually needs them)
        for h, created in self._conn().execute(
                "SELECT query_hash, created_at FROM query_cache"):
            self._cache_keys[h] = created

    FLUSH_INTERVAL_S = 0.25

    def _init_schema(self) -> None:
        with self._conn() as c:
            c.executescript("""
                CREATE TABLE IF NOT EXISTS query_feedback (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    timestamp REAL NOT NULL,
                    session_id TEXT,
                    query TEXT NOT NULL,
                    strategy TEXT,
                    rating INTEGER,
                    comment TEXT,
                    response_time_s REAL,
                    result_count INTEGER
                );
                CREATE TABLE IF NOT EXISTS query_cache (
                    query_hash TEXT PRIMARY KEY,
                    query TEXT NOT NULL,
                    result_json TEXT NOT NULL,
                    created_at REAL NOT NULL,
                    hit_count INTEGER DEFAULT 0,
                    last_hit_at REAL
                );
                CREATE TABLE IF NOT EXISTS analytics_summary (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    date TEXT NOT NULL,
                    total_queries INTEGER,
                    avg_rating REAL,
                    avg_response_time_s REAL,
                    details_json TEXT
                );
                CREATE TABLE IF NOT EXISTS system_performance (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    timestamp REAL NOT NULL,
                    cpu_pct REAL,
                    mem_pct REAL,
                    queries_per_minute REAL,
                    error_rate REAL
                );
            """)

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # 30s busy timeout: WAL allows one writer at a time, and under
            # an oversubscribed host (full test suite, serving + analytics
            # concurrently) a writer can hold the lock past sqlite's 5s
            # default, surfacing as 'database is locked'
            conn = sqlite3.connect(self.db_path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._local.conn = conn
        return conn

    # ------------------------------------------------------------ feedback

    def store_feedback(self, *, query: str, rating: Optional[int] = None,
                       comment: Optional[str] = None, strategy: Optional[str] = None,
                       session_id: Optional[str] = None, response_time_s: Optional[float] = None,
                       result_count: Optional[int] = None) -> int:
        with self._conn() as c:
            cur = c.execute(
                """INSERT INTO query_feedback(timestamp, session_id, query, strategy,
                       rating, comment, response_time_s, result_count)
                   VALUES (?,?,?,?,?,?,?,?)""",
                (time.time(), session_id, query, strategy, rating, comment,
                 response_time_s, result_count))
            return cur.lastrowid

    def rated_results(self, *, window_s: Optional[float] = None):
        """Rated queries joined with their cached retrieval results:
        yields (query, rating, result_dict) — the mining source for
        reranker fine-tuning (training/rerank_ft.mine_feedback_triples).
        The join is on the literal query text: the cache row the engine
        wrote for a query holds exactly the chunks the rated answer was
        built from. Queries whose cache entry has expired are skipped
        (their chunk lists are gone)."""
        self.flush_writes()
        q = """SELECT f.query, f.rating, c.result_json
               FROM query_feedback f JOIN query_cache c ON c.query = f.query
               WHERE f.rating IS NOT NULL"""
        args: tuple = ()
        if window_s is not None:
            q += " AND f.timestamp >= ?"
            args = (time.time() - window_s,)
        q += " ORDER BY f.timestamp"
        with self._conn() as c:
            rows = c.execute(q, args).fetchall()
        out = []
        for query, rating, result_json in rows:
            try:
                out.append((query, int(rating), json.loads(result_json)))
            except (ValueError, TypeError):
                continue
        return out

    # ------------------------------------------------- deferred batch writes

    def _ensure_writer(self) -> None:
        if not self._writer_started:
            self._writer_started = True
            threading.Thread(target=self._writer_loop, daemon=True,
                             name="feedback-db-writer").start()

    def _writer_loop(self) -> None:
        while True:
            time.sleep(self.FLUSH_INTERVAL_S)
            try:
                self.flush_writes()
            except Exception:  # noqa: BLE001 — a dead writer loses all writes
                import logging

                logging.getLogger(__name__).exception("feedback flush failed")

    def defer_feedback(self, *, query: str, rating: Optional[int] = None,
                       comment: Optional[str] = None, strategy: Optional[str] = None,
                       session_id: Optional[str] = None,
                       response_time_s: Optional[float] = None,
                       result_count: Optional[int] = None) -> None:
        """store_feedback, batched: ~1us on the caller; committed by the
        writer thread in one transaction with everything else pending."""
        self._ensure_writer()
        row = (time.time(), session_id, query, strategy, rating, comment,
               response_time_s, result_count)
        with self._plock:
            self._pending.append(("feedback", row))

    def defer_cache_put(self, query_hash: str, query: str, result: dict,
                        now: Optional[float] = None) -> None:
        """cache_put, batched. The result becomes visible to cache_get
        immediately (pending map) and durable at the next flush. Caller
        passes an owned dict (the engine hands a copy)."""
        self._ensure_writer()
        now = time.time() if now is None else now
        self._cache_keys[query_hash] = now
        self._cache_pending[query_hash] = result
        with self._plock:
            self._pending.append(("cache", (query_hash, query, result, now)))

    def flush_writes(self) -> None:
        """Commit all deferred writes in one transaction. Reads call this
        first, so analytics always observe completed queries. The flush
        lock makes that guarantee hold against a CONCURRENT flush: a caller
        blocks until any in-flight pop+commit completes rather than
        returning while those ops are still uncommitted."""
        with self._flush_lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        with self._plock:
            ops, self._pending = self._pending, []
        if not ops:
            return
        with self._conn() as c:
            for kind, row in ops:
                if kind == "feedback":
                    c.execute(
                        """INSERT INTO query_feedback(timestamp, session_id, query,
                               strategy, rating, comment, response_time_s, result_count)
                           VALUES (?,?,?,?,?,?,?,?)""", row)
                else:
                    query_hash, query, result, now = row
                    c.execute(
                        """INSERT INTO query_cache(query_hash, query, result_json, created_at)
                           VALUES (?,?,?,?)
                           ON CONFLICT(query_hash) DO UPDATE SET
                             result_json=excluded.result_json,
                             created_at=excluded.created_at""",
                        (query_hash, query, json.dumps(result, default=str), now))
        for kind, row in ops:
            if kind == "cache":
                self._cache_pending.pop(row[0], None)

    # --------------------------------------------------------- result cache

    def cache_get(self, query_hash: str, now: Optional[float] = None) -> Optional[dict]:
        now = time.time() if now is None else now
        created = self._cache_keys.get(query_hash)
        if created is None or now - created > self.cache_ttl_s:
            return None  # fast miss: no SQLite I/O
        pending = self._cache_pending.get(query_hash)
        if pending is not None:
            return dict(pending)
        row = self._conn().execute(
            "SELECT result_json, created_at FROM query_cache WHERE query_hash=?",
            (query_hash,)).fetchone()
        if row is None:
            return None
        result_json, created_at = row
        if now - created_at > self.cache_ttl_s:
            return None
        with self._conn() as c:
            c.execute(
                "UPDATE query_cache SET hit_count=hit_count+1, last_hit_at=? WHERE query_hash=?",
                (now, query_hash))
        return json.loads(result_json)

    def cache_put(self, query_hash: str, query: str, result: dict,
                  now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self._conn() as c:
            c.execute(
                """INSERT INTO query_cache(query_hash, query, result_json, created_at)
                   VALUES (?,?,?,?)
                   ON CONFLICT(query_hash) DO UPDATE SET
                     result_json=excluded.result_json, created_at=excluded.created_at""",
                (query_hash, query, json.dumps(result, default=str), now))
        self._cache_keys[query_hash] = now

    def cache_stats(self) -> dict:
        self.flush_writes()  # reads must observe deferred writes
        row = self._conn().execute(
            "SELECT COUNT(*), COALESCE(SUM(hit_count),0) FROM query_cache").fetchone()
        return {"entries": row[0], "total_hits": row[1]}

    # -------------------------------------------------------------- metrics

    def record_system_performance(self, *, cpu_pct: float = 0.0, mem_pct: float = 0.0,
                                  queries_per_minute: float = 0.0, error_rate: float = 0.0) -> None:
        with self._conn() as c:
            c.execute(
                """INSERT INTO system_performance(timestamp, cpu_pct, mem_pct,
                       queries_per_minute, error_rate) VALUES (?,?,?,?,?)""",
                (time.time(), cpu_pct, mem_pct, queries_per_minute, error_rate))

    def recent_system_performance(self, limit: int = 10) -> List[dict]:
        rows = self._conn().execute(
            """SELECT timestamp, cpu_pct, mem_pct, queries_per_minute, error_rate
               FROM system_performance ORDER BY timestamp DESC LIMIT ?""",
            (limit,)).fetchall()
        return [{"timestamp": r[0], "cpu_pct": r[1], "mem_pct": r[2],
                 "queries_per_minute": r[3], "error_rate": r[4]} for r in rows]

    def performance_summary(self, window_s: float = 24 * 3600) -> dict:
        self.flush_writes()  # reads must observe deferred writes
        cutoff = time.time() - window_s
        rows = self._conn().execute(
            """SELECT rating, response_time_s, result_count FROM query_feedback
               WHERE timestamp >= ?""", (cutoff,)).fetchall()
        ratings = [r[0] for r in rows if r[0] is not None]
        times = [r[1] for r in rows if r[1] is not None]
        return {
            "total_queries": len(rows),
            "avg_rating": sum(ratings) / len(ratings) if ratings else None,
            "avg_response_time_s": sum(times) / len(times) if times else None,
            "cache": self.cache_stats(),
        }

    # ------------------------------------------------------------ analytics

    def temporal_patterns(self, window_s: float = 7 * 24 * 3600) -> Dict[int, int]:
        """Queries per hour-of-day."""
        self.flush_writes()  # reads must observe deferred writes
        cutoff = time.time() - window_s
        rows = self._conn().execute(
            "SELECT timestamp FROM query_feedback WHERE timestamp >= ?", (cutoff,)).fetchall()
        hours = Counter(time.localtime(r[0]).tm_hour for r in rows)
        return dict(sorted(hours.items()))

    def keyword_frequency(self, top_n: int = 20, window_s: float = 7 * 24 * 3600) -> List[tuple]:
        self.flush_writes()  # reads must observe deferred writes
        cutoff = time.time() - window_s
        rows = self._conn().execute(
            "SELECT query FROM query_feedback WHERE timestamp >= ?", (cutoff,)).fetchall()
        stop = {"the", "a", "an", "is", "of", "in", "on", "to", "for", "what", "and", "or"}
        words = Counter()
        for (q,) in rows:
            words.update(w for w in q.lower().split() if w not in stop and len(w) > 2)
        return words.most_common(top_n)

    def detect_anomalies(self, window_s: float = 24 * 3600, z_threshold: float = 3.0) -> List[dict]:
        """Response-time outliers (z-score over the window)."""
        self.flush_writes()  # reads must observe deferred writes
        cutoff = time.time() - window_s
        rows = self._conn().execute(
            """SELECT query, response_time_s FROM query_feedback
               WHERE timestamp >= ? AND response_time_s IS NOT NULL""", (cutoff,)).fetchall()
        times = [r[1] for r in rows]
        if len(times) < 5:
            return []
        mean = sum(times) / len(times)
        var = sum((t - mean) ** 2 for t in times) / len(times)
        std = math.sqrt(var) or 1e-9
        return [
            {"query": q, "response_time_s": t, "z": (t - mean) / std}
            for q, t in rows if (t - mean) / std > z_threshold
        ]

    def session_journeys(self, window_s: float = 7 * 24 * 3600,
                         max_sessions: int = 50) -> Dict[str, List[str]]:
        """Per-session ordered query sequences (reference AdvancedAnalytics
        session journey capability)."""
        self.flush_writes()  # reads must observe deferred writes
        cutoff = time.time() - window_s
        rows = self._conn().execute(
            """SELECT session_id, query FROM query_feedback
               WHERE timestamp >= ? AND session_id IS NOT NULL
               ORDER BY timestamp""", (cutoff,)).fetchall()
        journeys: Dict[str, List[str]] = {}
        for sid, q in rows:
            journeys.setdefault(sid, []).append(q)
            if len(journeys) > max_sessions:
                break
        return journeys

    def strategy_transitions(self, window_s: float = 7 * 24 * 3600) -> Dict[str, int]:
        """Counts of strategy A->B transitions within sessions."""
        self.flush_writes()  # reads must observe deferred writes
        cutoff = time.time() - window_s
        rows = self._conn().execute(
            """SELECT session_id, strategy FROM query_feedback
               WHERE timestamp >= ? AND session_id IS NOT NULL AND strategy IS NOT NULL
               ORDER BY session_id, timestamp""", (cutoff,)).fetchall()
        out: Dict[str, int] = {}
        prev_sid = prev_strat = None
        for sid, strat in rows:
            if sid == prev_sid and prev_strat is not None:
                key = f"{prev_strat}->{strat}"
                out[key] = out.get(key, 0) + 1
            prev_sid, prev_strat = sid, strat
        return out

    def optimization_suggestions(self) -> List[str]:
        out: List[str] = []
        summary = self.performance_summary()
        if summary["avg_response_time_s"] and summary["avg_response_time_s"] > 5.0:
            out.append("average response time exceeds 5s: consider enlarging the "
                       "result cache TTL or pre-warming encoder compiles")
        if summary["avg_rating"] is not None and summary["avg_rating"] < 3.0:
            out.append("low average rating: review rerank blend weights and "
                       "retrieval candidate count")
        stats = self.cache_stats()
        if stats["entries"] > 0 and stats["total_hits"] == 0:
            out.append("result cache has entries but no hits: queries may be "
                       "too unique for caching to help")
        return out
