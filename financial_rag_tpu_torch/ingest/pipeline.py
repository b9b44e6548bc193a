"""Streaming ingestion pipeline: Marker JSON -> parents/children -> batched
device encode -> per-model index upsert.

Capability of reference parent_child/pipeline.py:31-223, redesigned for the device:
the reference embeds children model-after-model in one unbatched call per
model; here all child texts of a document are tokenized once and encoded in
large fixed-shape device batches per encoder, then upserted into that
encoder's index collection (children_<slug>, mirroring the reference's
per-model Chroma collections pipeline.py:116-136). Per-child LLM context is
optional and best-effort.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.ingest.chunker import ChildChunk, ParentChildChunker, ParentChunk
from financial_rag_tpu_torch.ingest.marker_json import parse_marker_json
from financial_rag_tpu_torch.llm.provider import LLMProvider, NullLLM, chunk_context
from financial_rag_tpu_torch.models.encoder import DualEncoder
from financial_rag_tpu_torch.store import ChildMetaStore, ParentStore
from financial_rag_tpu_torch.utils import get_logger, time_block

log = get_logger("ingest.pipeline")


def collection_slug(model_name: str) -> str:
    """children_<slug> collection naming (reference pipeline.py:116-119)."""
    return "children_" + re.sub(r"[^a-z0-9]+", "_", model_name.lower()).strip("_")


def pipelined_sweep(items, begin, finish) -> None:
    """The begin/finish overlap skeleton shared by ingest_paths and the
    serving processor's sweep: begin(item N+1) is dispatched BEFORE
    finish(item N) runs, so the next item's host work (parse, chunk,
    tokenize, extraction) overlaps the previous item's in-flight device
    encode. ``begin(item)`` returns a pending handle or None (handled /
    failed / empty — callers record their own outcome); ``finish(item,
    pending)`` must not raise for flow control (callers catch)."""
    prev = None   # (item, pending)
    for item in list(items) + [None]:
        nxt = None
        if item is not None:
            pending = begin(item)
            if pending is not None:
                nxt = (item, pending)
        if prev is not None:
            finish(*prev)
        prev = nxt


class IngestionPipeline:
    def __init__(
        self,
        dual_encoder: DualEncoder,
        parent_store: ParentStore,
        child_meta: ChildMetaStore,
        indexes: Dict[str, FlatIndex],       # model name -> index
        *,
        chunker: Optional[ParentChildChunker] = None,
        llm: Optional[LLMProvider] = None,
        chunk_logs_dir: Optional[str] = None,
        chunk_context_enabled: bool = False,
        multivector_index=None,
        token_encoder=None,
    ) -> None:
        assert set(indexes) == set(dual_encoder.names), \
            f"indexes {set(indexes)} must match encoders {set(dual_encoder.names)}"
        self.dual_encoder = dual_encoder
        self.parent_store = parent_store
        self.child_meta = child_meta
        self.indexes = indexes
        self.chunker = chunker or ParentChildChunker()
        self.llm = llm or NullLLM()
        self.chunk_logs_dir = Path(chunk_logs_dir) if chunk_logs_dir else None
        self.chunk_context_enabled = chunk_context_enabled
        # optional late-interaction tier (disabled by default, like the
        # reference's mv_enabled=False — pipeline.py:20)
        self.multivector_index = multivector_index
        self.token_encoder = token_encoder

    # ------------------------------------------------------------- ingest

    def _device_upsert_ok(self) -> bool:
        """Device-direct embedding handoff needs every index to accept
        device tensor payloads (FlatIndex does; IVF/sharded variants assign
        centroids host-side and take numpy)."""
        return all(getattr(type(idx), "supports_device_upsert", False)
                   for idx in self.indexes.values())

    def ingest_begin(
        self,
        json_path: str | Path,
        document_id: str,
        *,
        source_path: Optional[str] = None,
        source_mtime: Optional[float] = None,
    ) -> Optional[dict]:
        """Host parse/chunk + DISPATCH the dual-encoder device forwards.
        Returns a pending handle for ingest_finish, or None for an empty
        document. While the device encodes this document, the caller can
        ingest_begin the next one and ingest_finish the previous one —
        the producer/consumer overlap that takes ingest from ~12% to
        near-100% of raw dual-encode capability (the reference's loop is
        fully serial: encode-all-then-upsert per model, reference
        pipeline.py:122-143)."""
        t0 = time.perf_counter()
        json_path = Path(json_path)
        blocks = parse_marker_json(json_path)
        with time_block("ingest.chunk"):
            parents, children = self.chunker.chunk(blocks, document_id)
        if not parents:
            log.warning("document %s produced no content", document_id)
            return None

        if self.chunk_context_enabled and self.llm.available():
            parent_by_id = {p.parent_id: p for p in parents}
            for ch in children:
                ctx = chunk_context(self.llm, parent_by_id[ch.parent_id].content, ch.content)
                if ctx:
                    ch.context = ctx

        # batched dual-encoder embedding: context-augmented text is what gets
        # embedded when a context exists (contextual retrieval)
        texts = [f"{ch.context}\n{ch.content}" if ch.context else ch.content for ch in children]
        with time_block("ingest.encode_dispatch"):
            begun = self.dual_encoder.encode_all_begin(
                texts, device_out=self._device_upsert_ok())
        return {
            "document_id": document_id,
            "json_path": json_path,
            "source_path": source_path,
            "source_mtime": source_mtime,
            "parents": parents,
            "children": children,
            "begun": begun,
            "t0": t0,
        }

    def ingest_finish(self, pending: Optional[dict]) -> dict:
        """SQLite upserts (overlapping the in-flight device encode), then
        materialize embeddings into the per-model indexes."""
        if pending is None:
            return {"document_id": "", "parents": 0, "children": 0}
        document_id = pending["document_id"]
        parents, children = pending["parents"], pending["children"]

        # IDEMPOTENT re-ingest: ids are fresh snowflakes every attempt, so
        # any existing rows for this document are a previous version or a
        # failed attempt's partial commit — purge them so retries and
        # crash-replays converge instead of accumulating duplicates
        # (reference cleanup semantics, api_server.py:242-278, made
        # unconditional). The fetched ids feed remove_document directly
        # (no second SELECT). Children commit BEFORE parents so a crash
        # between the two leaves rows this children-keyed guard sees —
        # parents-first would orphan parent rows invisibly.
        old_children = self.child_meta.children_of_document(document_id)
        if old_children:
            self.remove_document(document_id, child_ids=old_children)

        self.child_meta.upsert_children([
            {"child_id": ch.child_id, "parent_id": ch.parent_id,
             "document_id": document_id, "snippet": ch.content, "context": ch.context,
             "source_path": pending["source_path"], "source_mtime": pending["source_mtime"]}
            for ch in children
        ])
        self.parent_store.upsert_parents([
            {"parent_id": p.parent_id, "document_id": p.document_id,
             "page_start": p.page_start, "page_end": p.page_end, "content": p.content}
            for p in parents
        ])

        ids = np.asarray([ch.child_id for ch in children], np.int64)
        for name, v in pending["begun"].items():
            with time_block("ingest.index_upsert"):
                self.indexes[name].upsert(ids, v() if callable(v) else v)

        if self.multivector_index is not None and self.token_encoder is not None:
            with time_block("ingest.multivector_upsert"):
                self.multivector_index.upsert(
                    ids, self.token_encoder.encode_tokens([ch.content for ch in children]))

        stats = {
            "document_id": document_id,
            "source_json": str(pending["json_path"]),
            "parents": len(parents),
            "children": len(children),
            "parent_tokens": [p.token_count for p in parents],
            "child_tokens": [ch.token_count for ch in children],
            "collections": {name: collection_slug(name) for name in self.indexes},
            "elapsed_s": round(time.perf_counter() - pending["t0"], 3),
        }
        self._write_chunk_log(document_id, parents, children, stats)
        log.info("ingested %s: %d parents, %d children in %.2fs",
                 document_id, len(parents), len(children), stats["elapsed_s"])
        return stats

    def ingest_extracted_json(
        self,
        json_path: str | Path,
        document_id: str,
        *,
        source_path: Optional[str] = None,
        source_mtime: Optional[float] = None,
    ) -> dict:
        pending = self.ingest_begin(json_path, document_id,
                                    source_path=source_path, source_mtime=source_mtime)
        if pending is None:
            return {"document_id": document_id, "parents": 0, "children": 0}
        return self.ingest_finish(pending)

    def ingest_paths(self, items: List[tuple]) -> List[dict]:
        """Pipelined multi-document ingest: begin(doc N+1) before
        finish(doc N), so doc N+1's chunk/tokenize and doc N's SQLite rows
        overlap doc N's device encode. items: (path, doc_id) pairs.
        Per-document failures are recorded and skipped."""
        results: List[Optional[dict]] = [None] * len(items)

        def begin(pos):
            path, doc_id = items[pos]
            try:
                pending = self.ingest_begin(path, doc_id)
                if pending is None:
                    results[pos] = {"document_id": doc_id, "parents": 0, "children": 0}
                return pending
            except Exception as e:  # noqa: BLE001 — ingest must keep going
                log.error("failed to ingest %s: %s", path, e)
                results[pos] = {"document_id": doc_id, "error": str(e)}
                return None

        def finish(pos, pending):
            try:
                results[pos] = self.ingest_finish(pending)
            except Exception as e:  # noqa: BLE001
                log.error("failed to ingest %s: %s", items[pos][0], e)
                results[pos] = {"document_id": items[pos][1], "error": str(e)}

        pipelined_sweep(range(len(items)), begin, finish)
        return results

    def flush(self) -> None:
        """Block until every dispatched index update has landed on device
        (throughput accounting; donation-safe since upserts serialize under
        each index's lock): one synchronize for each CUDA device that holds
        any index or any shard of one, the multivector tier's included."""
        indexes = list(self.indexes.values())
        if getattr(self, "multivector_index", None) is not None:
            indexes.append(self.multivector_index)
        devices = {dev for idx in indexes for dev in idx.storage_devices()
                   if dev.type == "cuda"}
        for dev in sorted(devices, key=str):
            torch.cuda.synchronize(dev)

    def ingest_directory(self, directory: str | Path) -> List[dict]:
        """Recursively ingest every extraction JSON (skipping *_meta.json,
        reference pipeline.py:203-223) through the pipelined path;
        per-file failures are logged and skipped."""
        directory = Path(directory)
        items = [(path, path.stem) for path in sorted(directory.rglob("*.json"))
                 if not path.name.endswith("_meta.json")]
        return self.ingest_paths(items)

    def remove_document(self, document_id: str, *,
                        child_ids: Optional[List[int]] = None) -> dict:
        """Delete a document's parents, children and vectors (re-ingest /
        cleanup semantics, reference api_server.py:242-278). ``child_ids``:
        pre-fetched ids (skips the lookup on the ingest hot path)."""
        if child_ids is None:
            child_ids = self.child_meta.children_of_document(document_id)
        removed = {name: idx.delete(child_ids) for name, idx in self.indexes.items()}
        if self.multivector_index is not None:
            removed["multivector"] = self.multivector_index.delete(child_ids)
        self.child_meta.delete_document(document_id)
        parents_removed = self.parent_store.delete_document(document_id)
        return {"document_id": document_id, "parents_removed": parents_removed,
                "children_removed": len(child_ids), "vectors_removed": removed}

    # ------------------------------------------------------------ logging

    def _write_chunk_log(self, document_id: str, parents: List[ParentChunk],
                         children: List[ChildChunk], stats: dict) -> None:
        if self.chunk_logs_dir is None:
            return
        self.chunk_logs_dir.mkdir(parents=True, exist_ok=True)
        payload = {
            **stats,
            "parents_detail": [
                {"parent_id": p.parent_id, "pages": [p.page_start, p.page_end],
                 "tokens": p.token_count, "content": p.content}
                for p in parents
            ],
            "children_detail": [
                {"child_id": ch.child_id, "parent_id": ch.parent_id,
                 "tokens": ch.token_count, "context": ch.context, "content": ch.content}
                for ch in children
            ],
        }
        out = self.chunk_logs_dir / f"{document_id}_parent_child_chunks.json"
        out.write_text(json.dumps(payload, indent=2, default=str))
