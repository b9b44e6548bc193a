"""Background auto-ingest document processor.

Capability of reference api_server.py:366-481: a daemon loop that scans the
source directory, detects new/changed/incomplete documents via the
processing ledger, cleans up stale versions (vectors + parents + chunk
logs), extracts, chunks, embeds, and persists state — so restarts resume
exactly where processing left off (SURVEY.md §5.4).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import List, Optional

from financial_rag_tpu_torch.ingest.extraction import run_marker
from financial_rag_tpu_torch.ingest.ledger import ProcessingLedger
from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline, pipelined_sweep
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("serving.processor")

SOURCE_EXTS = {".pdf", ".doc", ".docx", ".xls", ".xlsx", ".csv", ".ppt", ".pptx",
               ".txt", ".md", ".html", ".htm", ".json"}


class DocumentProcessor:
    def __init__(
        self,
        pipeline: IngestionPipeline,
        ledger: ProcessingLedger,
        *,
        source_dir: str | Path = "Source_Documents",
        extracted_dir: str | Path = "extracted",
        poll_interval_s: float = 30.0,
        on_sweep_complete=None,
    ) -> None:
        self.pipeline = pipeline
        self.ledger = ledger
        self.source_dir = Path(source_dir)
        self.extracted_dir = Path(extracted_dir)
        self.poll_interval_s = poll_interval_s
        # called after a sweep that processed documents — used to persist
        # the vector indexes so other processes see them (the reference's
        # Chroma store persisted implicitly)
        self.on_sweep_complete = on_sweep_complete
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._busy = False
        # serializes sweeps: the background loop and /admin/reprocess
        # threads may enter process_all concurrently, and the per-document
        # purge-flag protocol (read state -> refresh -> mark) is not
        # atomic across two sweeps touching the same path
        self._sweep_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="document-processor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.process_all()
            except Exception:  # noqa: BLE001 — the monitor must survive
                log.exception("processor sweep failed")
            self._stop.wait(self.poll_interval_s)

    # ----------------------------------------------------------- processing

    def process_all(self, force_paths: Optional[List[str]] = None) -> dict:
        """One sweep. force_paths: reprocess these regardless of state.
        Sweeps serialize (self._sweep_lock): a concurrent /admin/reprocess
        waits for the in-flight background sweep instead of interleaving."""
        with self._sweep_lock:
            return self._process_all_locked(force_paths)

    def _process_all_locked(self, force_paths: Optional[List[str]] = None) -> dict:
        self._busy = True
        try:
            paths = self.ledger.scan(self.source_dir, exts=SOURCE_EXTS)
            # purge documents whose sources were deleted
            purged = 0
            # re-purge tombstones from a previous sweep whose index
            # checkpoint FAILED (or a restart onto a stale checkpoint):
            # remove_missing already dropped their ledger entries, so this
            # list is the only remaining obligation — without it the stale
            # checkpoint resurrects the purged vectors as metadata-less
            # ghosts. remove_document is idempotent; counting them as purged
            # forces a fresh checkpoint attempt below.
            for t in self.ledger.purge_tombstones():
                doc_id = t["doc_id"]
                log.info("re-purging %s (purge not yet checkpointed)", doc_id)
                if t.get("child_ids"):
                    # after a crash the doc->children metadata is already
                    # gone (SQLite committed before death), so the ghost
                    # vectors the stale checkpoint resurrected can only be
                    # deleted by the ids the tombstone preserved
                    self.pipeline.remove_document(doc_id,
                                                  child_ids=t["child_ids"])
                else:
                    self.pipeline.remove_document(doc_id)
                purged += 1
            gone_docs = [Path(g).stem for g in self.ledger.remove_missing(paths)]
            if gone_docs:
                # tombstone every gone doc (with its child ids, captured
                # while the metadata still resolves them) and make the
                # tombstones DURABLE before the destructive purge: the
                # SQLite metadata deletion commits instantly while the
                # index purge lives only until the next checkpoint, so a
                # crash mid-purge would otherwise leave ghost vectors whose
                # ids nothing remembers (proven by
                # tests/test_crash_recovery.py before this ordering)
                meta = getattr(self.pipeline, "child_meta", None)
                for doc_id in gone_docs:
                    kids = (meta.children_of_document(doc_id)
                            if meta is not None else [])
                    self.ledger.add_purge_tombstone(doc_id, kids)
                self.ledger.save()
                for doc_id in gone_docs:
                    log.info("source removed, purging document %s", doc_id)
                    self.pipeline.remove_document(doc_id)
                    purged += 1

            processed, skipped, failed = [], [], []
            force = set(force_paths or [])
            todo = []
            for path in paths:
                try:
                    if path in force or self.ledger.needs_processing(path):
                        todo.append(path)
                    else:
                        skipped.append(path)
                except Exception as e:  # noqa: BLE001 — per-doc isolation:
                    # a file vanishing between scan and here must not abort
                    # the sweep for every other document
                    log.exception("failed to stat %s", path)
                    self.ledger.mark(path, error=str(e))
                    failed.append(path)

            # pipelined sweep (pipelined_sweep): extract + dispatch doc
            # N+1's device encode while doc N's encode is in flight, then
            # finish (SQLite + index upserts) doc N; per-doc failures
            # isolate to their doc
            def begin(path):
                try:
                    pending = self._begin_one(
                        path, changed=(path in force or self.ledger.has_changed(path)))
                    if pending is None:   # empty document: nothing to finish
                        self.ledger.mark(path, chunked=True, embedded=True, error=None)
                        processed.append(path)
                    return pending
                except Exception as e:  # noqa: BLE001 — per-doc isolation
                    log.exception("failed to process %s", path)
                    self.ledger.mark(path, error=str(e))
                    failed.append(path)
                    return None

            def finish(path, pending):
                try:
                    stats = self._finish_one(path, pending)
                    self.ledger.mark(path, chunked=True,
                                     embedded="error" not in stats,
                                     error=stats.get("error"))
                    processed.append(path)
                except Exception as e:  # noqa: BLE001
                    log.exception("failed to ingest %s", path)
                    self.ledger.mark(path, error=str(e))
                    failed.append(path)

            pipelined_sweep(todo, begin, finish)
            # persist the vector indexes BEFORE the ledger: a crash after
            # ledger.save but before the index checkpoint would leave
            # documents marked embedded whose vectors exist only in the
            # lost process — permanently unsearchable after restart. The
            # reverse order merely re-processes on restart, which the
            # purge-first ingest_finish makes idempotent. Deletion-only
            # sweeps persist too: the in-memory purge must not resurrect
            # from a stale checkpoint as metadata-less ghost vectors.
            if (processed or purged) and self.on_sweep_complete is not None:
                try:
                    self.on_sweep_complete()
                    # the checkpoint captured the purged state: the
                    # tombstones' retry obligation is discharged
                    self.ledger.clear_purge_tombstones()
                except Exception as e:  # noqa: BLE001 — must not kill the sweep
                    log.exception("on_sweep_complete failed")
                    # a FAILED checkpoint (not just a crash) must not let
                    # the ledger durably claim these documents are
                    # embedded — clear the flag so the next sweep retries
                    # (idempotent re-ingest makes that safe). Purge
                    # tombstones stay: the next sweep re-purges.
                    for p in processed:
                        self.ledger.mark(p, embedded=False,
                                         error=f"index persistence failed: {e}")
            elif self.on_sweep_complete is None:
                # no checkpoint layer: nothing stale to resurrect from
                self.ledger.clear_purge_tombstones()
            self.ledger.save()
            return {"processed": processed, "skipped": skipped, "failed": failed}
        finally:
            self._busy = False

    def _begin_one(self, path: str, changed: bool):
        """Extract + chunk + DISPATCH the device encode for one document;
        returns the pending handle for _finish_one (None for an empty
        document — a changed-to-empty doc purges its old content here).
        The caller finishes the PREVIOUS document while this one's encode
        is in flight. Cleanup of a CHANGED document's old content is
        deferred to _finish_one, so the old version stays searchable until
        the new one replaces it — pipelining would otherwise extend the
        invisibility window across the NEXT document's extraction. The
        purge obligation is persisted (ledger pending_purge): refresh_entry
        records the new sha NOW, so a failed attempt would otherwise make
        the retry see has_changed()=False and never purge."""
        doc_id = Path(path).stem
        prior = self.ledger.states.get(path)
        purge = changed or (prior.pending_purge if prior else False)
        st = self.ledger.refresh_entry(path)
        if purge:
            self.ledger.mark(path, pending_purge=True)

        extracted = run_marker(path, self.extracted_dir / doc_id)
        self.ledger.mark(path, extracted=True, extracted_path=str(extracted), error=None)
        pending = self.pipeline.ingest_begin(
            extracted, doc_id, source_path=path, source_mtime=st.mtime)
        if pending is None:
            if purge:
                log.info("document %s changed to empty; purging old content", doc_id)
                self.pipeline.remove_document(doc_id)
                self.ledger.mark(path, pending_purge=False)
            return None
        pending["_purge_old"] = purge
        return pending

    def _finish_one(self, path: str, pending: dict) -> dict:
        doc_id = Path(path).stem
        purge = pending.pop("_purge_old", False)
        if purge:
            # blue/green switch: old content served until this moment
            log.info("document %s changed; replacing old artifacts", doc_id)
            self.pipeline.remove_document(doc_id)
        stats = self.pipeline.ingest_finish(pending)
        if purge:
            # clear the obligation only AFTER the new content committed: a
            # failure inside ingest_finish leaves the flag set, so the
            # retry purges the partial commit (ingest_finish is also
            # idempotent-by-purge now — belt and braces)
            self.ledger.mark(path, pending_purge=False)
        return stats

    # ---------------------------------------------------------------- admin

    def status(self) -> dict:
        docs = {
            p: {
                "extracted": s.extracted,
                "chunked": s.chunked,
                "embedded": s.embedded,
                "error": s.error,
                "last_processed": s.last_processed,
            }
            for p, s in self.ledger.states.items()
        }
        return {
            "running": self.running,
            "busy": self._busy,
            "summary": self.ledger.summary(),
            "documents": docs,
        }

    def cleanup_orphans(self) -> dict:
        """Delete extraction outputs whose source no longer exists
        (reference api_server.py:1293-1334)."""
        removed = []
        if self.extracted_dir.is_dir():
            live = {Path(p).stem for p in self.ledger.scan(self.source_dir, exts=SOURCE_EXTS)}
            for d in self.extracted_dir.iterdir():
                if d.is_dir() and d.name not in live:
                    import shutil

                    shutil.rmtree(d, ignore_errors=True)
                    removed.append(str(d))
        return {"removed": removed}
