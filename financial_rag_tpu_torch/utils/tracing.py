"""Query-trace JSON artifacts — the system's primary observability tool
(capability of reference rag_backend.py:1258-1289): every query writes
question, generated query variants, retrieved children with scores, the
exact LLM prompt, and the answer, as a diffable regression artifact."""

from __future__ import annotations

import hashlib
import json
import threading
import time
from pathlib import Path
from typing import Optional

from financial_rag_tpu_torch.config import sanitize_for_json
from financial_rag_tpu_torch.utils.logging import get_logger

log = get_logger("utils.tracing")


class QueryTracer:
    """Trace artifacts are written off the hot path: `write` snapshots the
    payload synchronously (cheap dict building) and hands the JSON encode +
    disk IO to one daemon worker — profiled at ~6ms per query inline, a
    large slice of the end-to-end latency once retrieval itself is ~1ms.
    `flush()` joins the queue (used by tests and shutdown); if the queue
    backs up (disk stall), writes fall back to inline so traces are never
    silently dropped."""

    # ONE module-shared writer thread (lazily started): per-instance
    # threads + atexit handlers would leak a pinned daemon thread per
    # Runtime built (test suites build many).
    # A deque + 20ms poll instead of queue.Queue: Queue.put's per-item
    # notify is a cross-thread GIL handoff (~1ms profiled under load, pure
    # overhead on the request thread); deque.append is lock-free-ish (~1us)
    # and a 20ms write delay is irrelevant for trace artifacts.
    _shared_buf = None          # collections.deque
    _shared_busy = False        # drain thread mid-write (for flush)
    _shared_lock = threading.Lock()
    _MAX_QUEUED = 512

    def __init__(self, trace_dir: Optional[str | Path], *, background: bool = True) -> None:
        self.trace_dir = Path(trace_dir) if trace_dir else None
        self._background = background and self.trace_dir is not None
        self._dir_ready = False

    @classmethod
    def _writer_buf(cls):
        with cls._shared_lock:
            if cls._shared_buf is None:
                import atexit
                from collections import deque

                cls._shared_buf = deque()
                threading.Thread(target=cls._drain, daemon=True,
                                 name="query-tracer").start()
                # short-lived processes (scripts, benches) must not lose
                # queued traces — or race a tempdir teardown — at exit
                atexit.register(cls._flush_shared)
            return cls._shared_buf

    @classmethod
    def _drain(cls) -> None:
        buf = cls._shared_buf
        while True:
            if not buf:
                time.sleep(0.02)
                continue
            try:
                cls._shared_busy = True
                path, raw = buf.popleft()
                cls._write_file(path, cls._build_payload(raw))
            except IndexError:
                pass  # racing flush-time drain
            except Exception:  # noqa: BLE001 — a dead drain thread would
                log.exception("query-trace write failed")  # deadlock flush()
            finally:
                cls._shared_busy = False

    @staticmethod
    def _build_payload(raw: dict) -> dict:
        """Payload extraction + numpy sanitize, OFF the hot path (profiled
        ~1ms per query inline under load — pure GIL time)."""
        return sanitize_for_json({
            "timestamp": raw["timestamp"],
            "question": raw["question"],
            "generated_queries": list(raw["queries"]),
            "children": [
                {k: c.get(k) for k in
                 ("child_id", "parent_id", "retrieval_score", "final_rerank_score",
                  "cross_encoder_score", "text")}
                for c in raw["children"]
            ],
            "parents": [
                {k: p.get(k) for k in ("parent_id", "document_id", "page_start", "page_end")}
                for p in raw["parents"]
            ],
            "prompt": raw["prompt"],
            "answer": raw["answer"],
            "timings": raw["timings"] or {},
            **(raw["extra"] or {}),
        })

    @staticmethod
    def _write_file(path: Path, payload: dict) -> None:
        # compact separators: the artifact stays a diffable JSON document
        # (jq-friendly) at roughly half the encode time of indent=2 — at
        # 500+ QPS the writer thread's encode is real GIL pressure
        text = json.dumps(payload, separators=(",", ":"), default=str)
        try:
            path.write_text(text)
        except FileNotFoundError:
            # the trace dir can vanish between the one-time mkdir and a
            # background drain (temp-dir cleanup, blue/green data-dir swap);
            # recreate it and retry once
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(text)
            except OSError as e:
                log.warning("failed to write query trace: %s", e)
        except OSError as e:
            log.warning("failed to write query trace: %s", e)

    @classmethod
    def _flush_shared(cls) -> None:
        if cls._shared_buf is not None:
            while cls._shared_buf or cls._shared_busy:
                time.sleep(0.005)

    def flush(self) -> None:
        """Block until all queued traces are on disk."""
        self._flush_shared()

    def write(self, *, question: str, queries, children, parents, prompt: str,
              answer: str, timings: Optional[dict] = None, extra: Optional[dict] = None) -> Optional[Path]:
        if self.trace_dir is None:
            return None
        if not self._dir_ready:
            try:
                self.trace_dir.mkdir(parents=True, exist_ok=True)
                self._dir_ready = True
            except OSError as e:
                log.warning("failed to create trace dir: %s", e)
                return None
        ts = time.strftime("%Y%m%d_%H%M%S")
        digest = hashlib.sha256(question.encode("utf-8")).hexdigest()[:8]
        path = self.trace_dir / f"query_trace_{ts}_{digest}.json"
        # snapshot only references on the hot path; payload extraction and
        # sanitize run in the drain thread (the per-query child/parent dicts
        # are request-owned and never mutated after the response is built)
        raw = {"timestamp": time.time(), "question": question, "queries": queries,
               "children": children, "parents": parents, "prompt": prompt,
               "answer": answer, "timings": timings, "extra": extra}
        if self._background:
            buf = self._writer_buf()
            if len(buf) < self._MAX_QUEUED:
                buf.append((path, raw))
                return path
            # disk can't keep up: write inline (backpressure)
        self._write_file(path, self._build_payload(raw))
        return path
