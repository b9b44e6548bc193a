"""The port's HTTP serving surface against the JAX package's.

Both packages build the same stack as ``tests/test_engine_serving.py``'s
``stack`` fixture (HashingEncoder dim 128, FlatIndex capacity 1,024, the
lease and invoice documents from one shared source directory), and the same
requests go through werkzeug's test ``Client`` to both WSGI apps, in the
same order. Status, content type, CORS headers and JSON bodies must agree,
with what varies from run to run dropped: times, timestamps, snowflake child
ids (clock-based), and the host's CPU and memory readings. The tests import
werkzeug to drive both apps; the port's app does not
(``tests/test_torch_imports.py``).
"""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch
from werkzeug.test import Client

from financial_rag_tpu.engine import RAGEngine as JaxEngine
from financial_rag_tpu.index import FlatIndex as JaxFlatIndex
from financial_rag_tpu.ingest.ledger import ProcessingLedger as JaxLedger
from financial_rag_tpu.ingest.pipeline import IngestionPipeline as JaxPipeline
from financial_rag_tpu.models.encoder import DualEncoder as JaxDualEncoder
from financial_rag_tpu.models.hashing import HashingEncoder as JaxHashingEncoder
from financial_rag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
from financial_rag_tpu.retrieval.rerank import CrossEncoderReranker as JaxReranker
from financial_rag_tpu.serving.app import create_app as jax_create_app
from financial_rag_tpu.serving.processor import DocumentProcessor as JaxProcessor
from financial_rag_tpu.store import ChildMetaStore as JaxChildMeta
from financial_rag_tpu.store import ParentStore as JaxParentStore
from financial_rag_tpu.store.feedback_db import FeedbackDatabase as JaxFeedback
from financial_rag_tpu.utils.tracing import QueryTracer as JaxTracer
from financial_rag_tpu_torch.engine import RAGEngine
from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.ingest.ledger import ProcessingLedger
from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline, collection_slug
from financial_rag_tpu_torch.models.encoder import DualEncoder
from financial_rag_tpu_torch.models.hashing import HashingEncoder
from financial_rag_tpu_torch.retrieval.hybrid import HybridRetriever
from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderReranker
from financial_rag_tpu_torch.serving import app as port_app
from financial_rag_tpu_torch.serving.processor import DocumentProcessor
from financial_rag_tpu_torch.store import ChildMetaStore, ParentStore
from financial_rag_tpu_torch.store.feedback_db import FeedbackDatabase
from financial_rag_tpu_torch.utils.tracing import QueryTracer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

DOCS = {
    "lease": "The rent for the second year is Rs 42,800 per month. "
             "The lock-in period is 36 months. The lessor is M/s Bhartiya Enterprises. " * 4,
    "invoice": "Tax Invoice INV-42: total amount Rs 1,18,000. GST amount Rs 18,000 at 18 percent. " * 4,
}

JAX_PARTS = dict(dual=JaxDualEncoder, hashing=JaxHashingEncoder, flat=JaxFlatIndex,
                 parents=JaxParentStore, children=JaxChildMeta, pipeline=JaxPipeline,
                 hybrid=JaxHybrid, feedback=JaxFeedback, engine=JaxEngine, reranker=JaxReranker,
                 tracer=JaxTracer, ledger=JaxLedger, processor=JaxProcessor,
                 create_app=jax_create_app, index_kw={})
PORT_PARTS = dict(dual=DualEncoder, hashing=HashingEncoder, flat=FlatIndex,
                  parents=ParentStore, children=ChildMetaStore, pipeline=IngestionPipeline,
                  hybrid=HybridRetriever, feedback=FeedbackDatabase, engine=RAGEngine,
                  reranker=CrossEncoderReranker, tracer=QueryTracer, ledger=ProcessingLedger,
                  processor=DocumentProcessor, create_app=port_app.create_app,
                  index_kw={"device": "cpu"})

# what varies from run to run: drop these keys wherever they appear
VARYING = {"processingTime", "processing_time", "last_processed", "id", "docId", "system",
           "timings", "system_history", "performance", "suggestions"}


def _build(parts, work: Path, src: Path, *, saves: list):
    """``tests/test_engine_serving.py``'s stack from ``parts`` (one
    package's classes), over the shared ``src``; returns (app, engine,
    processor)."""
    work.mkdir()
    enc = parts["dual"]({"baai": parts["hashing"](dim=128, salt=1),
                         "gte": parts["hashing"](dim=128, salt=2)})
    indexes = {n: parts["flat"](dim=128, capacity=1024, name=collection_slug(n),
                                **parts["index_kw"]) for n in enc.names}
    parent_store = parts["parents"](work / "p.db")
    child_meta = parts["children"](work / "c.db")
    pipe = parts["pipeline"](enc, parent_store, child_meta, indexes)
    for doc_id in DOCS:
        f = src / f"{doc_id}.json"
        pipe.ingest_extracted_json(f, doc_id, source_path=str(f),
                                   source_mtime=f.stat().st_mtime)
    hybrid = parts["hybrid"](enc, indexes, child_meta)
    engine = parts["engine"](hybrid, parent_store, parts["reranker"](None),
                             feedback_db=parts["feedback"](work / "fb.db"),
                             tracer=parts["tracer"](work / "test_logs"))
    processor = parts["processor"](pipe, parts["ledger"](work / ".processing_state.json"),
                                   source_dir=src, extracted_dir=work / "extracted")
    app = parts["create_app"](engine, processor=processor, source_dir=str(src),
                              on_save=lambda: saves.append(sorted(indexes)))
    return app, engine, processor


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(jax client, port client, jax app, port app, save calls by package),
    one stack each over one source directory."""
    tmp = tmp_path_factory.mktemp("serving")
    src = tmp / "Source_Documents"
    src.mkdir()
    for doc_id, text in DOCS.items():
        (src / f"{doc_id}.json").write_text(json.dumps({"blocks": [{"content": text, "page": 0}]}))
    saves = {"jax": [], "port": []}
    jax_app, jax_engine, jax_proc = _build(JAX_PARTS, tmp / "jax", src, saves=saves["jax"])
    port_app_, port_engine, port_proc = _build(PORT_PARTS, tmp / "port", src,
                                               saves=saves["port"])
    jax_proc.process_all()
    port_proc.process_all()
    yield Client(jax_app), Client(port_app_), jax_app, port_app_, saves
    for engine in (jax_engine, port_engine):
        engine.flush_background()
    jax_app.sysperf.stop()
    jax_app.executor.shutdown(wait=True)
    port_app_.close()


def _norm(obj):
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items() if k not in VARYING}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _events(resp):
    return [json.loads(line[6:]) for line in resp.get_data(as_text=True).splitlines()
            if line.startswith("data: ")]


CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Headers",
        "Access-Control-Allow-Methods")

# (id, method, path, JSON body): replayed in this order against both apps
REQUESTS = [
    ("ui", "GET", "/", None),
    ("health", "GET", "/health", None),
    ("filters", "GET", "/filters", None),
    ("recent-documents", "GET", "/recent-documents", None),
    ("monitoring-status", "GET", "/monitoring-status", None),
    ("processing-status", "GET", "/admin/processing-status", None),
    ("search", "POST", "/search", {"query": "Who is the lessor?"}),
    ("search-filtered", "POST", "/search", {"query": "rent", "filters": {"fileType": ["word"]}}),
    ("search-empty", "POST", "/search", {"query": ""}),
    ("search-too-long", "POST", "/search", {"query": "x" * 5000}),
    ("search-no-body", "POST", "/search", None),
    ("search-stream", "POST", "/search-stream", {"query": "GST amount"}),
    ("search-stream-bad", "POST", "/search-stream", {"query": ""}),
    ("pdf-traversal", "GET", "/pdf?path=../../etc/passwd", None),
    ("pdf-missing-path", "GET", "/pdf", None),
    ("pdf-file", "GET", "/pdf?path=lease.json&download=true", None),
    ("pdf-not-found", "GET", "/pdf?path=nothing.pdf", None),
    ("cleanup", "POST", "/admin/cleanup", None),
    ("compact", "POST", "/admin/compact", None),
    ("save", "POST", "/admin/save", None),
    ("feedback", "POST", "/feedback", {"query": "test q", "rating": 4}),
    ("feedback-no-query", "POST", "/feedback", {"rating": 4}),
    ("metrics", "GET", "/metrics", None),
    ("options-search", "OPTIONS", "/search", None),
    ("options-get-route", "OPTIONS", "/health", None),
    ("head", "HEAD", "/health", None),
    ("unknown-path", "GET", "/nope", None),
    ("trailing-slash", "GET", "/health/", None),
    ("wrong-method-get", "GET", "/search", None),
    ("wrong-method-post", "POST", "/health", None),
    ("reprocess-wrong-method", "GET", "/admin/reprocess", None),
]


def _send(client, method, path, body):
    kw = {"json": body} if body is not None else {}
    return client.open(path, method=method, **kw)


@pytest.mark.parametrize("method,path,body", [r[1:] for r in REQUESTS],
                         ids=[r[0] for r in REQUESTS])
def test_port_app_answers_as_the_jax_app(apps, method, path, body):
    jax_client, port_client, *_ = apps
    want = _send(jax_client, method, path, body)
    got = _send(port_client, method, path, body)
    assert got.status_code == want.status_code
    assert got.headers.get("Content-Type") == want.headers.get("Content-Type")
    for name in CORS:
        assert got.headers.get(name) == want.headers.get(name), name
    if method == "HEAD":   # the GET route's headers, no body
        assert got.get_data() == want.get_data() == b""
        assert got.headers.get("Content-Length") == want.headers.get("Content-Length")
    elif want.mimetype == "application/json":
        assert got.get_json().keys() == want.get_json().keys()
        assert _norm(got.get_json()) == _norm(want.get_json())
    elif want.mimetype == "text/event-stream":
        assert got.headers.get("Cache-Control") == want.headers.get("Cache-Control") == "no-cache"
        assert got.headers.get("X-Accel-Buffering") == want.headers.get("X-Accel-Buffering")
        assert _norm(_events(got)) == _norm(_events(want))
    else:
        assert got.get_data() == want.get_data()


def test_search_stream_events_come_in_the_jax_order(apps):
    _, port_client, *_ = apps
    events = _events(port_client.post("/search-stream", json={"query": "lock-in period"}))
    assert [e["type"] for e in events] == ["chunks", "answer", "complete"]
    assert events[0]["data"]["documents"]
    assert events[1]["data"]["aiResponse"]["summary"]
    bad = _events(port_client.post("/search-stream", json={"query": ""}))
    assert [e["type"] for e in bad] == ["error"]


def test_save_and_reprocess_reach_the_runtime_hooks(apps):
    jax_client, port_client, jax_app, port_app_, saves = apps
    before = len(saves["port"])
    assert port_client.post("/admin/save").get_json() == {"status": "saved",
                                                           "collections": ["baai", "gte"]}
    assert saves["port"][before:] == [["baai", "gte"]]
    got = port_client.post("/admin/reprocess", json={"files": []}).get_json()
    want = jax_client.post("/admin/reprocess", json={"files": []}).get_json()
    assert got == want == {"status": "started", "files": 0}


def test_unhandled_error_becomes_json_500(apps, monkeypatch):
    _, port_client, _, port_app_, _ = apps
    monkeypatch.setattr(port_app_, "on_filters", lambda request: 1 / 0)
    resp = port_client.get("/filters")
    assert resp.status_code == 500
    assert resp.get_json() == {"error": "division by zero"}
    assert resp.headers["Access-Control-Allow-Origin"] == "*"


@pytest.mark.parametrize("content_type,body,want", [
    ("application/json", b'{"query": "rent"}', {"query": "rent"}),
    ("application/json; charset=utf-8", b'{"a": 1}', {"a": 1}),
    ("application/vnd.api+json", b'{"a": 1}', {"a": 1}),
    ("application/json", b"", None),
    ("application/json", b"{not json", None),
    ("text/plain", b'{"a": 1}', None),
    ("", b'{"a": 1}', None),
])
def test_request_json_is_silent_as_werkzeugs(content_type, body, want):
    """An empty or malformed body, or a body that is not declared JSON,
    reads as None, as werkzeug's ``get_json(silent=True)``."""
    import io

    from werkzeug.wrappers import Request as WerkzeugRequest

    def environ():
        return {"REQUEST_METHOD": "POST", "PATH_INFO": "/search", "QUERY_STRING": "",
                "CONTENT_TYPE": content_type, "CONTENT_LENGTH": str(len(body)),
                "wsgi.input": io.BytesIO(body), "SERVER_NAME": "x", "SERVER_PORT": "80",
                "wsgi.url_scheme": "http"}

    assert port_app.Request(environ()).get_json(silent=True) == want
    assert WerkzeugRequest(environ()).get_json(silent=True) == want


def test_query_arguments_keep_the_first_value_and_blanks():
    req = port_app.Request({"REQUEST_METHOD": "get", "PATH_INFO": "//pdf",
                            "QUERY_STRING": "path=a%20b.pdf&path=c&download=&x=1"})
    assert req.method == "GET" and req.path == "/pdf"
    assert req.args.get("path") == "a b.pdf"
    assert req.args.get("download", "false") == ""
    assert req.args.get("missing", "false") == "false"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_make_server_answers_a_real_socket(apps):
    """The threaded wsgiref server on 127.0.0.1 port 0: /search answers
    JSON, /search-stream sends its events in order as they are yielded, an
    unknown path is 404; shutdown ends the serving thread."""
    _, _, _, port_app_, _ = apps
    server = port_app.make_server(port_app_, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        with _post(f"{base}/search", {"query": "What is the GST amount?"}) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "application/json"
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
            data = json.loads(resp.read())
        assert data["status"] == "success" and data["documents"]
        with _post(f"{base}/search-stream", {"query": "GST amount"}) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream; charset=utf-8"
            assert resp.headers["Cache-Control"] == "no-cache"
            types = [json.loads(line[6:])["type"] for line in resp.read().decode().splitlines()
                     if line.startswith("data: ")]
        assert types == ["chunks", "answer", "complete"]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope", timeout=60)
        assert err.value.code == 404
        assert json.loads(err.value.read()) == {"error": "not found"}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_sse_events_leave_the_server_as_they_are_yielded(apps):
    """Each event is written to the socket when the handler yields it:
    the client reads the first event while the second is still held."""
    _, _, _, port_app_, _ = apps
    gate = threading.Event()

    def slow_stream(request):
        def events():
            yield "data: first\n\n"
            gate.wait(timeout=30)
            yield "data: second\n\n"
        return port_app.Response(events(), mimetype="text/event-stream")

    original = port_app_.on_search_stream
    port_app_.on_search_stream = slow_stream
    server = port_app.make_server(port_app_, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with _post(f"http://127.0.0.1:{server.server_port}/search-stream", {}) as resp:
            assert resp.readline() == b"data: first\n"
            gate.set()
            assert resp.read() == b"\ndata: second\n\n"
    finally:
        gate.set()
        port_app_.on_search_stream = original
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_static_page_is_the_jax_packages():
    page = "serving/static/index.html"
    assert ((ROOT / "financial_rag_tpu_torch" / page).read_bytes()
            == (ROOT / "financial_rag_tpu" / page).read_bytes())


def test_main_help_runs_without_werkzeug():
    """``python -m financial_rag_tpu_torch --help`` exits 0 in a fresh
    process, and the server's modules import with werkzeug, flask and JAX
    made unimportable."""
    proc = subprocess.run([sys.executable, "-m", "financial_rag_tpu_torch", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--auto-ingest" in proc.stdout
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('werkzeug', 'flask', 'jax', 'financial_rag_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import financial_rag_tpu_torch.__main__, financial_rag_tpu_torch.serving.app\n"
        "import financial_rag_tpu_torch.runtime\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('werkzeug', 'flask')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
