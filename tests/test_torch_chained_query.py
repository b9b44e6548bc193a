"""The port's device-chained query lane and coalesced waves on the CPU.

The cases of tests/test_chained_query.py on the port (retrieval/hybrid.py
``_dense_results_chained`` and serving/batcher.py ``MultiIndexBatcher``):
encoder outputs feed the index sweeps as device tensors and the sweep
results and query vectors come back in one device-to-host copy; parity
with the host-handoff path, the cache fill, the BatchingEncoder device-out
passthrough, ``collect(extra=...)``, and the chained waves. Then the whole
runtime under concurrent load: 16 threads through the batched port
runtime give the unbatched runtime's top-5 children, and the JAX
package's under the same settings.
"""

import json
import shutil
import threading

import numpy as np
import pytest
import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.index import FlatIndex
from financial_rag_tpu_torch.index.pending import collect, ready
from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline, collection_slug
from financial_rag_tpu_torch.models.checkpoint import random_params
from financial_rag_tpu_torch.models.encoder import DualEncoder, Encoder
from financial_rag_tpu_torch.retrieval.hybrid import HybridRetriever
from financial_rag_tpu_torch.store import ChildMetaStore, ParentStore
from financial_rag_tpu_torch.utils.embed_cache import EmbeddingCache

torch.set_num_threads(2)


def _tiny_encoder(seed: int) -> Encoder:
    cfg = ModelConfig(name=f"tiny-{seed}", hidden_size=128, num_layers=2,
                      num_heads=4, intermediate_size=256, vocab_size=30522,
                      max_position=512)
    return Encoder(cfg, random_params(cfg, seed=seed), pooling="mean", device="cpu")


@pytest.fixture(scope="module")
def encoders():
    return {"baai": _tiny_encoder(0), "gte": _tiny_encoder(1)}


@pytest.fixture
def stack(tmp_path, encoders):
    """A fully ingested stack with real (random-weight) encoders, so the
    device-out path carries genuine tensors."""
    enc = DualEncoder(dict(encoders), cache=EmbeddingCache(max_items=64))
    indexes = {n: FlatIndex(dim=128, capacity=256, name=collection_slug(n), device="cpu")
               for n in enc.names}
    parent_store = ParentStore(tmp_path / "p.db")
    child_meta = ChildMetaStore(tmp_path / "c.db")
    pipe = IngestionPipeline(enc, parent_store, child_meta, indexes)
    docs = {
        "lease": "The rent for the second year is Rs 42,800 per month. "
                 "The lock-in period is 36 months. " * 3,
        "invoice": "The GST amount charged is Rs 18,000 at 18 percent. " * 3,
    }
    for doc_id, text in docs.items():
        p = tmp_path / f"{doc_id}.json"
        p.write_text(json.dumps({"blocks": [{"content": text, "page": 0}]}))
        pipe.ingest_extracted_json(p, doc_id)
    return enc, indexes, child_meta


class _HostOnlyIndex:
    """Delegate WITHOUT accepts_device_queries/supports_search_begin:
    forces the host-handoff branch for the parity check."""

    supports_search_begin = False
    accepts_device_queries = False

    def __init__(self, inner):
        self.inner = inner

    def search(self, q, k):
        return self.inner.search(np.asarray(q, np.float32), k)

    def count(self):
        return self.inner.count()


class TestChainedQueryPath:
    def test_parity_with_host_handoff(self, stack):
        enc, indexes, child_meta = stack
        q = "What is the GST amount on the invoice?"
        chained = HybridRetriever(enc, indexes, child_meta)
        host = HybridRetriever(
            DualEncoder(dict(enc.encoders)),  # no cache: pure host encode
            {n: _HostOnlyIndex(i) for n, i in indexes.items()}, child_meta)
        a, _, _ = chained.retrieve_children(q)
        b, _, _ = host.retrieve_children(q)
        assert [c["child_id"] for c in a] == [c["child_id"] for c in b]
        np.testing.assert_allclose([c["retrieval_score"] for c in a],
                                   [c["retrieval_score"] for c in b], rtol=1e-5)

    def test_cache_filled_from_combined_pull(self, stack):
        enc, indexes, child_meta = stack
        h = HybridRetriever(enc, indexes, child_meta)
        q = "lock-in period months"
        assert enc.cached_all([q]) is None
        first, _, _ = h.retrieve_children(q)
        cached = enc.cached_all([q])
        assert cached is not None and set(cached) == set(enc.names)
        # second call runs entirely off the cache: encoding would blow up
        orig = enc.encode_all_begin
        enc.encode_all_begin = lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("re-encoded a fully cached query"))
        try:
            second, _, _ = h.retrieve_children(q)
        finally:
            enc.encode_all_begin = orig
        assert [c["child_id"] for c in first] == [c["child_id"] for c in second]
        fresh = DualEncoder(dict(enc.encoders)).encode_all([q])
        for name in enc.names:
            np.testing.assert_allclose(cached[name], fresh[name], rtol=1e-4, atol=1e-5)

    def test_cached_all_contract(self, stack):
        enc, _, _ = stack
        assert enc.cached_all([]) is None
        enc.cache.put("baai", "t1", np.ones(128, np.float32))
        assert enc.cached_all(["t1"]) is None  # gte still missing
        enc.cache.put("gte", "t1", np.ones(128, np.float32))
        got = enc.cached_all(["t1"])
        assert got is not None and got["baai"].shape == (1, 128)
        assert enc.cached_all(["t1", "t-missing"]) is None


class TestBatchingEncoderDeviceOut:
    def test_direct_lane_hands_out_device_tensors(self, encoders):
        from financial_rag_tpu_torch.serving.batcher import BatchingEncoder

        be = BatchingEncoder(encoders["baai"], direct=8, name="t-dev")
        try:
            out = be.encode_begin_device(["hello world"])()
            assert isinstance(out, torch.Tensor) and out.shape == (1, 128)
        finally:
            be.batcher.close()

    def test_no_direct_lane_falls_back_to_host(self, encoders):
        from financial_rag_tpu_torch.serving.batcher import BatchingEncoder

        be = BatchingEncoder(encoders["baai"], direct=0, name="t-host")
        try:
            out = be.encode_begin_device(["hello world"])()
            assert isinstance(out, np.ndarray) and out.shape == (1, 128)
        finally:
            be.batcher.close()


class TestCollectExtra:
    def test_extra_rides_the_same_transfer(self):
        p = ready(np.array([[1]], np.int64), np.array([[0.5]], np.float32))
        results, extra_host = collect([p], extra=[torch.arange(4.0)])
        assert results[0][0][0, 0] == 1
        np.testing.assert_array_equal(np.asarray(extra_host[0]),
                                      np.arange(4.0, dtype=np.float32))


class TestChainedWaveLane:
    """Coalesced device-chained waves: above the direct limit, concurrent
    requests' query texts coalesce into one wave that tokenizes once, runs
    one pinned-shape encode per model, feeds the device embeddings straight
    into every index sweep, and materializes everything (results and
    cache-fill vectors) in ONE device-to-host copy."""

    def _batcher(self, enc, indexes, **kw):
        from financial_rag_tpu_torch.serving.batcher import MultiIndexBatcher

        return MultiIndexBatcher(indexes, max_queries=16, chain_encoder=enc, **kw)

    def test_supports_chained_waves_gating(self, stack):
        from financial_rag_tpu_torch.models.hashing import HashingEncoder
        from financial_rag_tpu_torch.serving.batcher import MultiIndexBatcher

        enc, indexes, _ = stack
        assert self._batcher(enc, indexes).supports_chained_waves()
        assert not MultiIndexBatcher(indexes).supports_chained_waves()   # no chain encoder
        host_idx = {n: _HostOnlyIndex(i) for n, i in indexes.items()}
        assert not self._batcher(enc, host_idx).supports_chained_waves()
        hash_enc = DualEncoder({"baai": HashingEncoder(dim=128, salt=1),
                                "gte": HashingEncoder(dim=128, salt=2)})
        assert not self._batcher(hash_enc, indexes).supports_chained_waves()

    def test_concurrent_waves_match_per_request_search(self, stack):
        enc, indexes, _ = stack
        mib = self._batcher(DualEncoder(dict(enc.encoders)), indexes)
        queries = [["what is the monthly rent amount"],
                   ["GST amount charged", "lock-in period months"],
                   ["lessor name on the lease"],
                   ["tax invoice total"]]
        barrier = threading.Barrier(len(queries))
        results = [None] * len(queries)
        errors = []

        def run(i):
            try:
                barrier.wait()
                results[i] = mib.search_texts(queries[i], 4)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=run, args=(i,)) for i in range(len(queries))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in ts)
        assert mib.stats()["chained@k4"]["submitted"] == 4

        fresh = DualEncoder(dict(enc.encoders))
        for i, qs in enumerate(queries):
            vecs = fresh.encode_all(qs)
            for name, idx in indexes.items():
                want_ids, want_sc = idx.search(vecs[name], 4)
                got_ids, got_sc = results[i][name]
                np.testing.assert_array_equal(got_ids, want_ids)
                np.testing.assert_allclose(got_sc, want_sc, rtol=1e-4, atol=1e-5)

    def test_wave_fills_the_embedding_cache(self, stack):
        enc, indexes, _ = stack
        chain = DualEncoder(dict(enc.encoders), cache=EmbeddingCache(max_items=64))
        mib = self._batcher(chain, indexes)
        q = "rent for the second year"
        assert chain.cached_all([q]) is None
        mib.search_texts([q], 4)
        cached = chain.cached_all([q])
        assert cached is not None
        fresh = DualEncoder(dict(enc.encoders)).encode_all([q])
        for name in chain.names:
            np.testing.assert_allclose(cached[name], fresh[name], rtol=1e-4, atol=1e-5)

    def test_hybrid_routes_through_the_chained_wave(self, stack):
        enc, indexes, child_meta = stack
        mib = self._batcher(DualEncoder(dict(enc.encoders)), indexes)
        h = HybridRetriever(enc, indexes, child_meta, sweep_batcher=mib)
        baseline = HybridRetriever(enc, indexes, child_meta)
        q = "What is the GST amount on the invoice?"
        a, _, _ = h.retrieve_children(q)
        b, _, _ = baseline.retrieve_children(q)
        assert [c["child_id"] for c in a] == [c["child_id"] for c in b]
        np.testing.assert_allclose([c["retrieval_score"] for c in a],
                                   [c["retrieval_score"] for c in b], rtol=1e-5)
        st = mib.stats()
        chained = [v for k, v in st.items() if k.startswith("chained@")]
        assert chained and chained[0]["calls"] >= 1
        assert not any(v["calls"] for k, v in st.items() if not k.startswith("chained@"))

    def test_hybrid_hot_query_skips_the_wave_encode(self, stack):
        """A repeated query whose embeddings are already in the query cache
        does NOT re-encode: it takes the vector (search_all) wave."""
        enc, indexes, child_meta = stack
        # runtime wiring: the retriever's dual encoder and the batcher's
        # chain encoder SHARE one EmbeddingCache (runtime.py)
        cache = EmbeddingCache(max_items=64)
        dual = DualEncoder(dict(enc.encoders), cache=cache)
        chain = DualEncoder(dict(enc.encoders), cache=cache)
        mib = self._batcher(chain, indexes)
        h = HybridRetriever(dual, indexes, child_meta, sweep_batcher=mib)
        q = "What is the GST amount on the invoice?"
        first, _, _ = h.retrieve_children(q)     # cold: chained wave, fills cache

        def calls(chained):
            return sum(v["calls"] for k, v in mib.stats().items()
                       if k.startswith("chained@") == chained)

        chained_before = calls(True)
        assert chained_before >= 1
        second, _, _ = h.retrieve_children(q)    # hot: cache hit, vector wave
        assert calls(True) == chained_before     # no second encode
        assert calls(False) >= 1
        assert [c["child_id"] for c in second] == [c["child_id"] for c in first]

    def test_warmup_runs_the_chained_shapes(self, stack):
        enc, indexes, _ = stack
        mib = self._batcher(DualEncoder(dict(enc.encoders)), indexes)
        mib.warmup(4)   # must not raise; covers the vector and chained waves
        got = mib.search_texts(["monthly rent"], 4)
        assert set(got) == set(indexes) and got["baai"][0].shape == (1, 4)

    def test_long_query_wave_picks_a_covering_seq_bucket(self, stack):
        """A wave containing one long query must not truncate it: the
        pinned bucket covers the wave's longest text."""
        enc, indexes, _ = stack
        mib = self._batcher(DualEncoder(dict(enc.encoders)), indexes)
        long_q = "the total amount due including all taxes and fees " * 12
        got = mib.search_texts([long_q], 4)
        fresh = DualEncoder(dict(enc.encoders)).encode_all([long_q])
        for name, idx in indexes.items():
            want_ids, want_sc = idx.search(fresh[name], 4)
            np.testing.assert_array_equal(got[name][0], want_ids)
            np.testing.assert_allclose(got[name][1], want_sc, rtol=1e-4, atol=1e-5)


# ------------------------------------------------- runtimes under load

LOAD_THREADS = 16


def _top5(out):
    assert out["success"] and out["top_children_chunks"], out.get("answer")
    return [c["child_id"] for c in out["top_children_chunks"][:5]]


def _concurrent(rt, questions):
    barrier = threading.Barrier(len(questions))
    out, errors = {}, []

    def run(q):
        try:
            barrier.wait()
            out[q] = rt.engine.query(q)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    ts = [threading.Thread(target=run, args=(q,)) for q in questions]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert not errors and len(out) == len(questions) and not any(t.is_alive() for t in ts), errors
    return out


def test_runtime_under_load_matches_unbatched_and_jax(tmp_path, monkeypatch):
    """One seeded checkpoint set and corpus, ingested once by the port's
    SERVE_MICROBATCH=0 runtime and saved; two copies of its data dir
    (without feedback.db, whose result cache would answer) serve the port's
    and the JAX package's runtimes with SERVE_MICROBATCH=1,
    MICROBATCH_DIRECT=0, so every request goes through the batchers. 16
    threads at once, one question each: both give the unbatched runtime's
    top-5 child ids, and the port's sweep wave and rerank coalesce."""
    from financial_rag_tpu.config import FrameworkConfig as JaxFrameworkConfig
    from financial_rag_tpu.runtime import Runtime as JaxRuntime
    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.runtime import Runtime
    from test_torch_slice import CORPUS, GOLDEN, _config, _write_checkpoint

    monkeypatch.delenv("FRAG_PLATFORM", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    ckpt = tmp_path / "ckpt"
    for name, seed, clf in (("bge", 1, False), ("gte", 2, False), ("ce", 3, True)):
        _write_checkpoint(ckpt / name, seed=seed, classifier=clf)
    src = tmp_path / "src"
    src.mkdir()
    base = Runtime.build(_config(FrameworkConfig, ckpt), data_dir=tmp_path / "base",
                         device="cpu")
    for doc_id, text in CORPUS.items():
        f = src / f"{doc_id}.json"
        f.write_text(json.dumps({"blocks": [{"content": text, "page": 0}]}))
        assert "error" not in base.pipeline.ingest_extracted_json(
            f, doc_id, source_path=str(f), source_mtime=0.0)
    base.save_indexes(tmp_path / "base")
    questions = GOLDEN + [f"Please tell me: {q}" for q in GOLDEN[:LOAD_THREADS - len(GOLDEN)]]
    assert len(set(questions)) == LOAD_THREADS
    want = {q: _top5(base.engine.query(q)) for q in questions}

    got = {}
    for tag, cls, rt_cls, kw in (("port", FrameworkConfig, Runtime, {"device": "cpu"}),
                                 ("jax", JaxFrameworkConfig, JaxRuntime, {})):
        data = tmp_path / tag
        shutil.copytree(tmp_path / "base", data, ignore=shutil.ignore_patterns("feedback.db*"))
        cfg = _config(cls, ckpt)
        cfg.serving.microbatch, cfg.serving.microbatch_direct = True, 0
        rt = rt_cls.build(cfg, data_dir=data, **kw)
        assert rt.hybrid.sweep_batcher.supports_chained_waves()
        out = _concurrent(rt, questions)
        assert not any(o.get("cache_hit") for o in out.values())
        got[tag] = {q: _top5(o) for q, o in out.items()}
        if tag == "port":
            sweep = rt.hybrid.sweep_batcher.stats()
            rerank = rt.engine.reranker.model.stats()
    assert got["port"] == want
    assert got["jax"] == want
    (wave,) = [v for k, v in sweep.items() if k.startswith("chained@")]
    assert wave["submitted"] == LOAD_THREADS and wave["calls"] < wave["submitted"], sweep
    assert rerank["submitted"] > 0 and rerank["calls"] < rerank["submitted"], rerank
    assert rerank["direct"] == 0
