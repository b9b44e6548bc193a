"""RAG query engine: the single-strategy orchestrator.

Capability of reference rag_backend.py execute_single_strategy /
rag_query_enhanced (rag_backend.py:864-1356): normalize -> hybrid child
retrieval -> pre-rerank filters -> cross-encoder rerank -> ordered parent
dedup -> prompt -> LLM answer (graceful fallback) -> query trace, with an
md5-keyed result cache (1h TTL) in the feedback DB and the reference's full
response schema so the existing React UI works unchanged.
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional

from financial_rag_tpu_torch.config import FrameworkConfig
from financial_rag_tpu_torch.llm.prompts import build_answer_prompt
from financial_rag_tpu_torch.llm.provider import (
    LLMProvider,
    NullLLM,
    stream_answer,
    synthesize_answer,
)
from financial_rag_tpu_torch.retrieval.filters import build_filter, passes_filter
from financial_rag_tpu_torch.retrieval.hybrid import HybridRetriever
from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderReranker
from financial_rag_tpu_torch.store import ParentStore
from financial_rag_tpu_torch.store.feedback_db import FeedbackDatabase
from financial_rag_tpu_torch.utils import QueryAnalyzer, get_logger, safe_mean, time_block
from financial_rag_tpu_torch.utils.tracing import QueryTracer

log = get_logger("engine")


class RAGEngine:
    def __init__(
        self,
        hybrid: HybridRetriever,
        parent_store: ParentStore,
        reranker: Optional[CrossEncoderReranker] = None,
        llm: Optional[LLMProvider] = None,
        *,
        config: Optional[FrameworkConfig] = None,
        feedback_db: Optional[FeedbackDatabase] = None,
        tracer: Optional[QueryTracer] = None,
        active=None,
    ) -> None:
        self.hybrid = hybrid
        self.parent_store = parent_store
        self.reranker = reranker or CrossEncoderReranker(None)
        self.llm = llm or NullLLM()
        self.cfg = config or FrameworkConfig()
        self.feedback_db = feedback_db
        self.tracer = tracer or QueryTracer(None)
        self.analyzer = QueryAnalyzer()
        # shared concurrency gauge for the serving batchers' adaptive
        # direct-lane policy (serving/batcher.ActiveCount): the engine
        # brackets each request so the gauge counts concurrent QUERIES
        self.active = active

    def flush_background(self) -> None:
        """Drain deferred persistence (trace files, cache/feedback writes).

        Post-response persistence is deferred-and-batched inside its owners
        (FeedbackDatabase.defer_* writer thread, QueryTracer drain thread) —
        profiled at ~4-6ms of SQLite commits + JSON encodes per query when
        inline. Tests and shutdown call this to make everything durable."""
        if self.feedback_db is not None:
            self.feedback_db.flush_writes()
        self.tracer.flush()

    # ----------------------------------------------------------- public API

    def query(self, question: str, topn: int = 5, filters: Optional[dict] = None,
              enable_reranking: bool = True, session_id: Optional[str] = None) -> dict:
        if self.active is not None:
            self.active.enter()
            try:
                return self._query(question, topn=topn, filters=filters,
                                   enable_reranking=enable_reranking,
                                   session_id=session_id)
            finally:
                self.active.leave()
        return self._query(question, topn=topn, filters=filters,
                           enable_reranking=enable_reranking, session_id=session_id)

    def _query(self, question: str, topn: int = 5, filters: Optional[dict] = None,
               enable_reranking: bool = True, session_id: Optional[str] = None) -> dict:
        start = time.time()
        cache_key = None
        if self.feedback_db is not None:
            cache_key = hashlib.md5(
                f"{question}|{topn}|{filters}|{enable_reranking}".encode()).hexdigest()
            with time_block("engine.cache_get"):
                cached = self.feedback_db.cache_get(cache_key)
            if cached is not None:
                cached["cache_hit"] = True
                return cached
        try:
            result = self._execute(question, topn=topn, filters=filters,
                                   enable_reranking=enable_reranking,
                                   session_id=session_id, start=start)
            if self.feedback_db is not None and result.get("success", True):
                # deferred batch write (~1us): the writer thread commits it
                # with everything else pending in one transaction
                self.feedback_db.defer_cache_put(cache_key, question, dict(result))
            return result
        except Exception as e:  # noqa: BLE001 — API contract: errors become answers
            log.exception("RAG query failed")
            return {
                "answer": f"I encountered an error processing your query: {e}",
                "chunks": [],
                "top_children_chunks": [],
                "query_strategy": "Error",
                "success": False,
                "processing_time": time.time() - start,
            }

    # -------------------------------------------------- progressive stream

    def query_stream(self, question: str, topn: int = 5, filters: Optional[dict] = None,
                     session_id: Optional[str] = None):
        """Generator yielding ("chunks", top_children) as soon as retrieval
        and rerank finish, then ("complete", full_result) after answer
        synthesis. Genuine progressive streaming — the reference computes
        everything first and inserts an artificial 0.5s delay between
        events (reference api_server.py:1137)."""
        start = time.time()
        if self.active is not None:
            self.active.enter()
        try:
            ctx = self._retrieve_phase(question, topn=topn, filters=filters, start=start)
            if "no_match" in ctx:
                yield "chunks", []
                yield "complete", ctx["no_match"]
                return
            yield "chunks", self._ui_children(ctx["top_children"], {})
            # progressive answer: providers that can stream (on-device
            # LocalLLM segments) yield text deltas before the final result;
            # non-streaming providers fall through untouched
            parents = self._gather_parents(ctx)
            deltas: List[str] = []
            gen = stream_answer(self.llm, question, parents,
                                related_queries=ctx["queries"][1:])
            completed = False
            try:
                while True:
                    delta = next(gen)
                    deltas.append(delta)
                    yield "answer_delta", delta
            except StopIteration as fin:
                completed = bool(fin.value)
            streamed = "".join(deltas).strip()
            # a mid-generation failure leaves a TRUNCATED fragment: don't
            # store it as the final answer — regenerate via the
            # synthesize_answer degradation chain (the final "complete"
            # event replaces the progressive text client-side)
            if not completed and streamed:
                log.warning("answer stream truncated mid-generation; "
                            "falling back to one-shot synthesis")
                streamed = ""
            result = self._finish_phase(question, ctx, session_id=session_id,
                                        start=start, parents=parents,
                                        answer=streamed or None)
            yield "complete", result
        except Exception as e:  # noqa: BLE001 — stream errors become a result
            log.exception("streaming RAG query failed")
            yield "complete", {
                "answer": f"I encountered an error processing your query: {e}",
                "chunks": [], "top_children_chunks": [],
                "query_strategy": "Error", "success": False,
                "processing_time": time.time() - start,
            }
        finally:
            if self.active is not None:
                self.active.leave()

    # ------------------------------------------------------------ internals

    def _retrieve_phase(self, question: str, *, topn: int, filters: Optional[dict],
                        start: float, enable_reranking: bool = True) -> dict:
        top_children_n = max(topn * 3, self.cfg.retrieval.top_children)

        analysis = self.analyzer.analyze(question)
        strategy = "Aggregation" if analysis.intent == "aggregation" else "Specific"

        child_chunks, child_parent, queries = self.hybrid.retrieve_children(
            question, max_children=top_children_n)

        # pre-rerank filters (reference rag_backend.py:870-1042)
        f = build_filter(filters)
        if f.active:
            child_chunks = [
                c for c in child_chunks
                if passes_filter(f, c.get("source_path"), c.get("source_mtime"))
            ]
            if not child_chunks:
                return {"no_match": self._no_match_response(question, f, start)}

        if enable_reranking and self.cfg.rerank.enabled:
            with time_block("engine.rerank"):
                reranked = self.reranker.rerank_chunks(question, child_chunks,
                                                       strategy=strategy)
        else:
            reranked = sorted(child_chunks,
                              key=lambda c: c.get("retrieval_score", 0.0), reverse=True)

        def child_score(c: dict) -> float:
            return float(c.get("final_rerank_score", c.get("retrieval_score", 0.0)))

        top_children = sorted(reranked, key=child_score, reverse=True)[:top_children_n]
        return {
            "strategy": strategy, "queries": queries, "filter": f,
            "child_chunks": child_chunks, "child_parent": child_parent,
            "top_children": top_children, "child_score": child_score,
        }

    @staticmethod
    def _ui_children(top_children, parent_doc):
        return [
            {
                "chunk_id": c.get("chunk_id"),
                "child_id": c.get("child_id"),
                "parent_id": c.get("parent_id"),
                "document_name": c.get("document_id") or parent_doc.get(c.get("parent_id")),
                "source_path": c.get("source_path"),
                "source_mtime": c.get("source_mtime"),
                "text": c.get("chunk_text", c.get("text", "")),
                "retrieval_score": c.get("retrieval_score"),
                "final_rerank_score": c.get("final_rerank_score"),
            }
            for c in top_children
        ]

    def _execute(self, question: str, *, topn: int, filters: Optional[dict],
                 enable_reranking: bool, session_id: Optional[str], start: float) -> dict:
        ctx = self._retrieve_phase(question, topn=topn, filters=filters,
                                   start=start, enable_reranking=enable_reranking)
        if "no_match" in ctx:
            return ctx["no_match"]
        return self._finish_phase(question, ctx, session_id=session_id, start=start)

    def _gather_parents(self, ctx: dict) -> list:
        """Ordered parent dedup + fetch (reference rag_backend.py:1091-1104)."""
        child_parent, top_children = ctx["child_parent"], ctx["top_children"]
        parent_ids: List[int] = []
        for c in top_children:
            pid = c.get("parent_id") or child_parent.get(c.get("child_id"))
            if pid is not None and pid not in parent_ids:
                parent_ids.append(pid)
        with time_block("engine.parents"):
            return self.parent_store.get_parents_by_ids(
                parent_ids[:self.cfg.retrieval.top_parents])

    def _finish_phase(self, question: str, ctx: dict, *, session_id: Optional[str],
                      start: float, parents: Optional[list] = None,
                      answer: Optional[str] = None) -> dict:
        """``parents``/``answer`` may be precomputed by the streaming path
        (query_stream yields answer deltas first, then reuses them here)."""
        strategy, queries, f = ctx["strategy"], ctx["queries"], ctx["filter"]
        child_chunks, child_parent = ctx["child_chunks"], ctx["child_parent"]
        top_children, child_score = ctx["top_children"], ctx["child_score"]

        if parents is None:
            parents = self._gather_parents(ctx)

        prompt = build_answer_prompt(queries[0] if queries else question, parents,
                                     related_queries=queries[1:])
        if answer is None:
            with time_block("engine.llm"):
                answer = synthesize_answer(self.llm, question, parents,
                                           related_queries=queries[1:])

        processing_time = time.time() - start
        parent_chunks = [
            {
                "chunk_id": f"parent_{p['parent_id']}",
                "parent_id": p["parent_id"],
                "document_id": p["document_id"],
                "document_name": p["document_id"],
                "text": p["content"],
                "page_start": p.get("page_start"),
                "page_end": p.get("page_end"),
                "relevance_score": 1.0 - i * 0.1,
            }
            for i, p in enumerate(parents)
        ]
        parent_doc = {p["parent_id"]: p["document_id"] for p in parents}

        result = {
            "answer": answer,
            "llm_prompt": prompt,
            "corrected_query": queries[0] if queries else question,
            "multiqueries": queries[1:],
            "chunks": parent_chunks,
            "top_children_chunks": self._ui_children(top_children, parent_doc),
            "all_chunks_count": len(parent_chunks),
            "processing_time": processing_time,
            "session_id": session_id or "anonymous",
            "avg_relevance_score": safe_mean([child_score(c) for c in top_children]),
            "query_strategy": strategy,
            "retrieval_method": "single_strategy_child_parent",
            "retrieval_info": {
                "queries": queries,
                "top_children": len(child_chunks),
                "parents": len(parents),
                "filter_active": f.active,
            },
            # kept for response-schema compatibility with the reference
            # (rag_backend.py:1291-1330); always None/simple in the live path
            "optimization_result": None,
            "savings_info": None,
            "processing_method": "simple",
            "hierarchical_stats": None,
            "agent_used": "Single-Strategy",
            "success": True,
        }

        self.tracer.write(question=question, queries=queries, children=top_children,
                          parents=parents, prompt=prompt, answer=answer,
                          timings={"total_s": processing_time})
        if self.feedback_db is not None:
            self.feedback_db.defer_feedback(
                query=question, strategy=strategy, session_id=session_id,
                response_time_s=processing_time, result_count=len(top_children))
        return result

    def _no_match_response(self, question: str, f, start: float) -> dict:
        parts = []
        if f.allowed_exts is not None:
            parts.append("file type")
        if f.min_ts is not None or f.max_ts is not None:
            parts.append(f.label or "time range")
        selected = ", ".join(parts) if parts else "selected filter(s)"
        return {
            "answer": f"No documents matched your filter: {selected}. "
                      "Try adjusting or clearing the filter and search again.",
            "llm_prompt": "",
            "corrected_query": question,
            "multiqueries": [],
            "chunks": [],
            "top_children_chunks": [],
            "all_chunks_count": 0,
            "processing_time": time.time() - start,
            "session_id": "anonymous",
            "avg_relevance_score": 0.0,
            "query_strategy": "Simple",
            "retrieval_method": "single_strategy_child_parent",
            "retrieval_info": {"queries": [], "top_children": 0, "parents": 0,
                               "filter_active": True},
            "agent_used": "Single-Strategy",
            "success": True,
        }

    # ------------------------------------------------------------- health

    def health(self) -> dict:
        return {
            "status": "ok",
            "indexes": {name: idx.count() for name, idx in self.hybrid.indexes.items()},
            "parents": self.parent_store.count(),
            "reranker_healthy": getattr(self.reranker, "healthy", False),
            "llm_available": self.llm.available(),
        }
