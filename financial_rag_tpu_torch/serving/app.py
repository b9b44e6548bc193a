"""REST + SSE API server (WSGI, on the standard library).

Counterpart of financial_rag_tpu/serving/app.py, with the same wire
contract (reference api_server.py §2.3, SURVEY.md), so the existing React
UI (amber-ai-search) can be pointed at either server. Endpoints:

  POST /search                  {query, filters} -> {documents, aiResponse, ...}
  POST /search-stream           SSE: chunks -> answer -> complete (errors as error events)
  GET  /health                  status + monitoring flag
  GET  /filters                 available filter values
  GET  /pdf?path=&download=     serve source files (path-traversal guarded)
  GET  /recent-documents        20 most recently modified sources
  GET  /monitoring-status       background-processor flag
  GET  /admin/processing-status per-document pipeline state
  POST /admin/reprocess         force re-ingest (all or listed files)
  POST /admin/cleanup           delete orphaned extraction artifacts
  POST /admin/compact           compact / retrain every index
  POST /admin/save              persist every index now
  GET  /metrics                 timing + cache + analytics (beyond reference)
  POST /feedback                store user feedback (beyond reference's stub)

The JAX app is built on werkzeug; this one needs only the standard library,
so it runs where werkzeug is not installed. ``Request``, ``Response`` and
the route table are small pieces of this module that give the handlers
(``on_*``, kept as the JAX app has them) what they use of werkzeug's: the
method, the query arguments, a silent JSON body, and a body of bytes, text
or an iterator of either. Routing answers as werkzeug's does: an unknown path 404, a known path with another method 405,
HEAD on every GET route. ``run_server`` serves from a threaded ``wsgiref``
server (HTTP/1.0: a streamed response ends when the server closes the
connection), built by ``make_server``, which a caller can bind to port 0
and shut down.
"""

from __future__ import annotations

import json
import mimetypes
import os
import re
import socketserver
import threading
import time
from concurrent.futures import ThreadPoolExecutor, TimeoutError as FuturesTimeout
from datetime import datetime
from http import HTTPStatus
from pathlib import Path
from typing import Iterable, Optional, Union
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer
from wsgiref.simple_server import make_server as _wsgiref_server

from financial_rag_tpu_torch.config import FrameworkConfig
from financial_rag_tpu_torch.engine import RAGEngine
from financial_rag_tpu_torch.serving.formatting import (
    _ui_file_type,
    format_ai_response,
    format_chunks_for_ui,
)
from financial_rag_tpu_torch.serving.processor import DocumentProcessor
from financial_rag_tpu_torch.utils import get_logger, validate_and_sanitize_query
from financial_rag_tpu_torch.utils.sanitize import QueryValidationError
from financial_rag_tpu_torch.utils.timing import GLOBAL_TIMER

log = get_logger("serving.app")

# werkzeug's MethodNotAllowed description, which the JAX app returns as its error
METHOD_NOT_ALLOWED = "The method is not allowed for the requested URL."
# werkzeug adds a charset to these content types (and to every text/*)
_CHARSET_TYPES = ("application/ecmascript", "application/javascript", "application/sql",
                  "application/xml", "application/xml-dtd",
                  "application/xml-external-parsed-entity")


class Request:
    """What the handlers read of a WSGI request: ``method``, ``path``,
    ``args`` (the query string, first value of each key, blanks kept) and
    ``get_json``."""

    def __init__(self, environ: dict) -> None:
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = re.sub("/{2,}", "/", environ.get("PATH_INFO") or "/")
        self.args = {key: values[0] for key, values in
                     parse_qs(environ.get("QUERY_STRING", ""), keep_blank_values=True).items()}
        self._body: Optional[bytes] = None

    @property
    def mimetype(self) -> str:
        return self.environ.get("CONTENT_TYPE", "").split(";", 1)[0].strip().lower()

    def get_data(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            stream = self.environ.get("wsgi.input")
            self._body = stream.read(length) if stream is not None and length > 0 else b""
        return self._body

    def get_json(self, silent: bool = True):
        """The JSON body, or None where the content type is not JSON or the
        body is empty or malformed: werkzeug's ``get_json(silent=True)``,
        the only form the handlers call (``silent`` is taken for that)."""
        mt = self.mimetype
        if not (mt == "application/json" or (mt.startswith("application/")
                                              and mt.endswith("+json"))):
            return None
        try:
            return json.loads(self.get_data())
        except ValueError:
            return None


class Response:
    """A status, headers and a body of bytes, text, or an iterator of either
    (sent chunk by chunk, each as soon as it is yielded)."""

    def __init__(self, body: Union[bytes, str, Iterable] = b"", status: int = 200,
                 mimetype: Optional[str] = None, headers: Optional[dict] = None) -> None:
        self.status_code = status
        self.body = body
        mimetype = mimetype or "text/plain"
        if mimetype.startswith("text/") or mimetype in _CHARSET_TYPES or mimetype.endswith("+xml"):
            mimetype += "; charset=utf-8"
        self.headers = {"Content-Type": mimetype, **(headers or {})}

    def __call__(self, environ: dict, start_response):
        body = self.body.encode() if isinstance(self.body, str) else self.body
        headers = dict(self.headers)
        if isinstance(body, bytes) and self.status_code != 204:
            headers["Content-Length"] = str(len(body))
        status = f"{self.status_code} {HTTPStatus(self.status_code).phrase.upper()}"
        start_response(status, list(headers.items()))
        if environ.get("REQUEST_METHOD", "GET").upper() == "HEAD" or self.status_code == 204:
            return [b""]
        if isinstance(body, bytes):
            return [body]
        return (chunk.encode() if isinstance(chunk, str) else chunk for chunk in body)


def _json(payload, status: int = 200) -> Response:
    return Response(json.dumps(payload, default=str), status=status,
                    mimetype="application/json")


# the JAX app's 15 rules: path -> (handler suffix, methods); GET also takes HEAD
ROUTES = {
    "/": ("ui", ("GET",)),
    "/search": ("search", ("POST", "OPTIONS")),
    "/search-stream": ("search_stream", ("POST", "OPTIONS")),
    "/health": ("health", ("GET",)),
    "/monitoring-status": ("monitoring_status", ("GET",)),
    "/filters": ("filters", ("GET",)),
    "/pdf": ("pdf", ("GET",)),
    "/recent-documents": ("recent_documents", ("GET",)),
    "/admin/processing-status": ("processing_status", ("GET",)),
    "/admin/reprocess": ("reprocess", ("POST",)),
    "/admin/cleanup": ("cleanup", ("POST",)),
    "/admin/compact": ("compact", ("POST",)),
    "/admin/save": ("save", ("POST",)),
    "/metrics": ("metrics", ("GET",)),
    "/feedback": ("feedback", ("POST",)),
}


class RagApi:
    """WSGI application implementing the search API contract. ``close``
    stops its request executor and its system-performance thread."""

    def __init__(
        self,
        engine: RAGEngine,
        *,
        processor: Optional[DocumentProcessor] = None,
        config: Optional[FrameworkConfig] = None,
        source_dir: Optional[str] = None,
        on_save=None,
    ) -> None:
        self.engine = engine
        self.processor = processor
        self._save_hook = on_save   # runtime-provided index persistence hook
        self.cfg = config or FrameworkConfig()
        self.src_dir = Path(source_dir or self.cfg.ingest.source_dir)
        self.executor = ThreadPoolExecutor(max_workers=8, thread_name_prefix="search")
        from financial_rag_tpu_torch.utils.sysperf import SystemPerformanceRecorder

        self.sysperf = SystemPerformanceRecorder(
            engine.feedback_db, interval_s=self.cfg.serving.sysperf_interval_s)
        if engine.feedback_db is not None and self.cfg.serving.sysperf_interval_s > 0:
            self.sysperf.start()

    def close(self) -> None:
        self.sysperf.stop()
        self.executor.shutdown(wait=True, cancel_futures=True)

    # ---------------------------------------------------------------- WSGI

    def __call__(self, environ, start_response):
        request = Request(environ)
        try:
            route = ROUTES.get(request.path)
            if route is None:
                response = _json({"error": "not found"}, 404)
            else:
                endpoint, methods = route
                allowed = methods + ("HEAD",) if "GET" in methods else methods
                if request.method not in allowed:
                    response = _json({"error": METHOD_NOT_ALLOWED}, 405)
                elif request.method == "OPTIONS":
                    response = Response("", status=204)
                else:
                    response = getattr(self, f"on_{endpoint}")(request)
        except Exception as e:  # noqa: BLE001 — API errors become JSON
            log.exception("unhandled API error")
            response = _json({"error": str(e)}, 500)
        response.headers["Access-Control-Allow-Origin"] = "*"
        response.headers["Access-Control-Allow-Headers"] = "Content-Type"
        response.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
        return response(environ, start_response)

    # ------------------------------------------------------------------ UI

    def on_ui(self, request: Request) -> Response:
        page = Path(__file__).resolve().parent / "static" / "index.html"
        return Response(page.read_bytes(), mimetype="text/html")

    # -------------------------------------------------------------- search

    def _run_query(self, query: str, filters: Optional[dict]) -> dict:
        return self.engine.query(query, filters=filters)

    def on_search(self, request: Request) -> Response:
        body = request.get_json(silent=True) or {}
        try:
            query = validate_and_sanitize_query(body.get("query", ""),
                                                self.cfg.serving.max_query_len)
        except QueryValidationError as e:
            return _json({"error": str(e)}, 400)

        future = self.executor.submit(self._run_query, query, body.get("filters"))
        try:
            result = future.result(timeout=self.cfg.serving.request_timeout_s)
        except FuturesTimeout:
            self.sysperf.record_request(ok=False)
            return _json({"error": "Search timed out. Please try again."}, 504)
        except Exception:
            self.sysperf.record_request(ok=False)
            raise
        self.sysperf.record_request(ok=result.get("success", True))

        documents = format_chunks_for_ui(
            result.get("top_children_chunks") or result.get("chunks") or [])
        return _json({
            "documents": documents,
            "aiResponse": format_ai_response(result.get("answer", ""), documents),
            "query": query,
            "status": "success" if result.get("success", True) else "error",
            "method": "rag_enhanced",  # fixed label (reference api_server.py:922-928)
            "processingTime": result.get("processing_time"),
        })

    def on_search_stream(self, request: Request) -> Response:
        body = request.get_json(silent=True) or {}
        raw_query = body.get("query", "")
        filters = body.get("filters")
        delay = self.cfg.serving.sse_inter_event_delay_s
        timeout = self.cfg.serving.request_timeout_s

        def sse(payload: dict) -> str:
            return f"data: {json.dumps(payload, default=str)}\n\n"

        def generate():
            try:
                try:
                    query = validate_and_sanitize_query(raw_query, self.cfg.serving.max_query_len)
                except QueryValidationError as e:
                    yield sse({"type": "error", "data": {"error": str(e)}})
                    return
                # genuine progressive streaming: chunks flush as soon as
                # retrieval+rerank finish, the answer follows after LLM
                # synthesis (the reference computes everything, then sleeps
                # 0.5s between events — reference api_server.py:1137).
                # Each phase advances inside the executor with a deadline so
                # a hung retrieval/rerank/LLM call becomes a timeout event
                # (same bound on_search enforces with future.result).
                deadline = time.monotonic() + timeout
                stream = iter(self.engine.query_stream(query, filters=filters))
                streamed_docs: list = []   # chunks-phase documents, for refs
                done = object()
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.sysperf.record_request(ok=False)
                        yield sse({"type": "error",
                                   "data": {"error": "Streaming search timed out. Please try again."}})
                        return
                    step_future = self.executor.submit(next, stream, done)
                    try:
                        step = step_future.result(timeout=remaining)
                    except FuturesTimeout:
                        step_future.cancel()
                        self.sysperf.record_request(ok=False)
                        yield sse({"type": "error",
                                   "data": {"error": "Streaming search timed out. Please try again."}})
                        return
                    if step is done:
                        break
                    phase, payload = step
                    if phase == "chunks":
                        streamed_docs = format_chunks_for_ui(payload)
                        yield sse({"type": "chunks",
                                   "data": {"documents": streamed_docs}})
                        if delay:
                            time.sleep(delay)
                    elif phase == "answer_delta":
                        # progressive on-device LLM tokens (engine streams
                        # them only when the provider can); an extra event
                        # type — clients that only know chunks/answer/
                        # complete ignore it and still get the full answer
                        yield sse({"type": "answer_partial",
                                   "data": {"text": payload}})
                    else:  # complete
                        yield sse({"type": "answer",
                                   "data": {"aiResponse":
                                            format_ai_response(payload.get("answer", ""),
                                                               streamed_docs)}})
                        yield sse({"type": "complete",
                                   "data": {"status": "success", "method": "rag_enhanced"}})
                        self.sysperf.record_request(ok=True)
            except Exception as e:  # noqa: BLE001 — stream errors become events
                log.exception("search-stream failed")
                self.sysperf.record_request(ok=False)
                yield sse({"type": "error", "data": {"error": str(e)}})

        return Response(generate(), mimetype="text/event-stream",
                        headers={"Cache-Control": "no-cache", "X-Accel-Buffering": "no"})

    # ---------------------------------------------------------------- meta

    def on_health(self, request: Request) -> Response:
        return _json({
            **self.engine.health(),
            "status": "healthy",
            "monitoring_active": bool(self.processor and self.processor.running),
        })

    def on_monitoring_status(self, request: Request) -> Response:
        return _json({"monitoring_active": bool(self.processor and self.processor.running)})

    def on_filters(self, request: Request) -> Response:
        return _json({
            "fileTypes": ["pdf", "word", "excel", "ppt", "txt"],
            # only sources that actually back documents: every ingested
            # chunk is attributed "Windows Shares" (serving/formatting.py),
            # so advertising unbacked sources here would let the UI build
            # filters that silently match nothing (ADVICE r2)
            "dataSources": ["Windows Shares"],
            "timeRanges": ["all", "3days", "week", "month", "3months", "year",
                           "5years", "custom"],
        })

    def on_pdf(self, request: Request) -> Response:
        rel = request.args.get("path")
        if not rel:
            return _json({"error": "Path parameter is required"}, 400)
        base = self.src_dir.resolve()
        target = (base / rel).resolve()
        if target != base and not str(target).startswith(str(base) + os.sep):
            return _json({"error": "Access denied"}, 403)
        if not target.is_file():
            return _json({"error": "File not found"}, 404)
        download = request.args.get("download", "false").lower() == "true"
        mime = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
        resp = Response(target.read_bytes(), mimetype=mime)
        if download:
            resp.headers["Content-Disposition"] = f'attachment; filename="{target.name}"'
        return resp

    def on_recent_documents(self, request: Request) -> Response:
        if not self.src_dir.is_dir():
            return _json({"documents": [], "status": "success"})
        files = []
        for p in self.src_dir.rglob("*"):
            if p.is_file():
                try:
                    files.append((p, p.stat().st_mtime))
                except OSError:
                    continue
        files.sort(key=lambda x: x[1], reverse=True)
        docs = [
            {
                "id": f"doc_{i}",
                "title": p.name,
                # same mapping search results use (_ui_file_type), so the
                # home screen's recent-docs icons agree with result cards
                "fileType": _ui_file_type(str(p)),
                "sourcePath": str(p),
                "lastAccessed": datetime.fromtimestamp(m).isoformat() + "Z",
                "sourceType": "Windows Shares",
            }
            for i, (p, m) in enumerate(files[:20], start=1)
        ]
        return _json({"documents": docs, "status": "success"})

    # --------------------------------------------------------------- admin

    def on_processing_status(self, request: Request) -> Response:
        if self.processor is None:
            return _json({"error": "processor not configured"}, 404)
        return _json(self.processor.status())

    def on_reprocess(self, request: Request) -> Response:
        if self.processor is None:
            return _json({"error": "processor not configured"}, 404)
        body = request.get_json(silent=True) or {}
        paths = body.get("files")
        if paths is None:
            paths = self.processor.ledger.scan(self.processor.source_dir)
        t = threading.Thread(target=self.processor.process_all,
                             kwargs={"force_paths": list(paths)}, daemon=True)
        t.start()
        return _json({"status": "started", "files": len(list(paths))})

    def on_cleanup(self, request: Request) -> Response:
        if self.processor is None:
            return _json({"error": "processor not configured"}, 404)
        return _json(self.processor.cleanup_orphans())

    def on_compact(self, request: Request) -> Response:
        """Index maintenance: compact tombstoned slots (flat) / retrain
        centroids (IVF) on every collection that supports it."""
        out = {}
        for name, idx in self.engine.hybrid.indexes.items():
            if hasattr(idx, "compact"):
                out[name] = {"reclaimed_slots": idx.compact()}
            elif hasattr(idx, "retrain"):
                idx.retrain()
                out[name] = {"retrained": True, "count": idx.count()}
            else:
                out[name] = {"skipped": True}
        return _json({"status": "ok", "collections": out})

    def on_save(self, request: Request) -> Response:
        """Persist every index to host storage NOW (on top of the
        automatic post-sweep persistence): an explicit checkpoint before
        planned maintenance or shutdown."""
        if self._save_hook is None:
            return _json({"error": "no persistence hook configured"}, 404)
        self._save_hook()
        return _json({"status": "saved",
                      "collections": list(self.engine.hybrid.indexes)})

    # -------------------------------------------------------------- extras

    def on_metrics(self, request: Request) -> Response:
        out = {"timings": GLOBAL_TIMER.summary(),
               "system": self.sysperf.snapshot()}
        # serving coalescing observability: per-wrapper wave stats, incl.
        # the LLM's direct/coalesced/continuous-engine split
        stats = getattr(self.engine.llm, "stats", None)
        if callable(stats):
            out["llm_batching"] = stats()
        if self.engine.feedback_db is not None:
            out["performance"] = self.engine.feedback_db.performance_summary()
            out["suggestions"] = self.engine.feedback_db.optimization_suggestions()
            out["system_history"] = self.engine.feedback_db.recent_system_performance()
        return _json(out)

    def on_feedback(self, request: Request) -> Response:
        if self.engine.feedback_db is None:
            return _json({"error": "feedback db not configured"}, 404)
        body = request.get_json(silent=True) or {}
        if not body.get("query"):
            return _json({"error": "query is required"}, 400)
        fid = self.engine.feedback_db.store_feedback(
            query=body["query"], rating=body.get("rating"),
            comment=body.get("comment"), session_id=body.get("session_id"))
        return _json({"status": "stored", "id": fid})



def create_app(
    engine: RAGEngine,
    *,
    processor: Optional[DocumentProcessor] = None,
    config: Optional[FrameworkConfig] = None,
    source_dir: Optional[str] = None,
    on_save=None,
) -> RagApi:
    return RagApi(engine, processor=processor, config=config,
                  source_dir=source_dir, on_save=on_save)


class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    """One thread a connection; they do not hold the process open."""

    daemon_threads = True


class _Handler(WSGIRequestHandler):
    def log_message(self, format, *args) -> None:  # noqa: A002 — the base class's name
        log.info("%s %s", self.address_string(), format % args)


def make_server(app: RagApi, host: str = "127.0.0.1", port: int = 0) -> ThreadingWSGIServer:
    """A threaded WSGI server for ``app`` bound to (host, port); port 0
    takes a free one (``server.server_port``). Serve with
    ``serve_forever()``; stop with ``shutdown()`` and ``server_close()``."""
    return _wsgiref_server(host, port, app, server_class=ThreadingWSGIServer,
                           handler_class=_Handler)


def run_server(app: RagApi, host: str = "0.0.0.0", port: int = 5000) -> None:
    server = make_server(app, host, port)
    log.info("serving on http://%s:%d", host, server.server_port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        app.close()
