"""The port's multivector tier (index/multivector.py MultiVectorIndex and
models/encoder.py TokenEncoder) against the JAX package's on the CPU.

Each case of tests/test_multivector.py runs through the port and, on the
same numpy inputs, through the JAX package. Tolerances: hit ids identical;
scores within rtol 1e-5 of JAX's in f32 storage and within 1e-4 (absolute)
in bf16 storage; the numpy oracle within rtol 1e-4 (as the JAX test);
TokenEncoder vectors at cosine > 0.9999 per token against JAX's on a 2-layer
random checkpoint, and within 2e-5 between batched and per-text calls.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from financial_rag_tpu.index import MultiVectorIndex as JaxMultiVectorIndex
from financial_rag_tpu.models.hashing import HashingEncoder as JaxHashingEncoder
from financial_rag_tpu_torch.index import FlatIndex, MultiVectorIndex
from financial_rag_tpu_torch.index import multivector as mv_mod
from financial_rag_tpu_torch.models.hashing import HashingEncoder

torch.set_num_threads(2)


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _np_maxsim(qv, token_store, masks):
    """Oracle: sum_q max_t (q . tokens[c, t]) with masked tokens at -inf."""
    scores = []
    for toks, m in zip(token_store, masks):
        sims = qv @ toks.T
        sims[:, m == 0] = -np.inf
        scores.append(sims.max(axis=1).sum())
    return np.asarray(scores)


def _pair(dim, max_child_tokens, capacity, dtype="float32", chunk=64):
    """(port index on the CPU, JAX index) of one configuration."""
    jdtype = np.float32 if dtype == "float32" else jnp.bfloat16
    return (MultiVectorIndex(dim=dim, max_child_tokens=max_child_tokens, capacity=capacity,
                             dtype=np.float32 if dtype == "float32" else torch.bfloat16,
                             chunk=chunk, device="cpu"),
            JaxMultiVectorIndex(dim=dim, max_child_tokens=max_child_tokens, capacity=capacity,
                                dtype=jdtype, chunk=chunk))


def _same_hits(got, want, dtype="float32"):
    assert [h["child_id"] for h in got] == [h["child_id"] for h in want]
    g, w = [h["score"] for h in got], [h["score"] for h in want]
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


@pytest.mark.smoke
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_maxsim_vs_oracle_and_jax(rng, dtype):
    d, tc, n, tq, k = 64, 16, 200, 5, 10
    token_counts = rng.integers(3, tc, n)
    token_store, masks, vecs_list = [], [], []
    for c in token_counts:
        v = _unit(rng, c, d)
        vecs_list.append(v)
        padded = np.zeros((tc, d), np.float32)
        padded[:c] = v
        m = np.zeros(tc, np.float32)
        m[:c] = 1
        token_store.append(padded)
        masks.append(m)

    idx, jidx = _pair(d, tc, 256, dtype)
    ids = np.arange(10, 10 + n, dtype=np.int64)
    idx.upsert(ids, vecs_list)
    jidx.upsert(ids, vecs_list)
    assert idx.count() == len(idx) == n
    assert idx._tokens.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)

    qv = _unit(rng, tq, d)
    hits = idx.search_aggregate(qv, top_k=k)
    _same_hits(hits, jidx.search_aggregate(qv, top_k=k), dtype)
    if dtype == "float32":
        oracle = _np_maxsim(qv, token_store, masks)
        assert [h["child_id"] for h in hits] == ids[np.argsort(-oracle, kind="stable")[:k]].tolist()
        np.testing.assert_allclose([h["score"] for h in hits], np.sort(oracle)[::-1][:k],
                                   rtol=1e-4)


@pytest.mark.parametrize("sweep_bytes", [4 * 5 * 16 * 64, 1 << 26], ids=["chunked", "whole"])
def test_sweep_chunk_size_does_not_change_the_hits(rng, monkeypatch, sweep_bytes):
    """A search sweeps as many children as fit SWEEP_BYTES of f32
    similarities: at one 64-child chunk a sweep (4 sweeps) and all at once
    the hits are JAX's."""
    monkeypatch.setattr(mv_mod, "SWEEP_BYTES", sweep_bytes)
    idx, jidx = _pair(64, 16, 256)
    vs = [_unit(rng, int(c), 64) for c in rng.integers(1, 17, 230)]
    idx.upsert(np.arange(1, 231), vs)
    jidx.upsert(np.arange(1, 231), vs)
    q = _unit(rng, 5, 64)
    assert idx._sweep_rows(5) == (64 if sweep_bytes < 1 << 20 else 256)
    _same_hits(idx.search_aggregate(q, top_k=30), jidx.search_aggregate(q, top_k=30))


def test_ties_go_to_the_lower_slot(rng):
    """Identical token sets score identically: the lower slot (the earlier
    upsert) comes first, as the JAX package's running top-k merge over its
    64-child chunks gives (slot 70 is in its second chunk)."""
    idx, jidx = _pair(32, 8, 128, chunk=64)
    base = _unit(rng, 4, 32)
    others = [_unit(rng, 4, 32) for _ in range(70)]
    # ids 500 (slot 0), 7 (slot 1) and 90 (slot 70, the second chunk) tie
    ids = [500, 7] + list(range(1000, 1068)) + [90]
    vecs = [base, base] + others[:68] + [base]
    for index in (idx, jidx):
        index.upsert(ids, vecs)
    hits = idx.search_aggregate(base, top_k=5)
    assert [h["child_id"] for h in hits[:3]] == [500, 7, 90]
    assert hits[0]["score"] == hits[1]["score"] == hits[2]["score"]
    _same_hits(hits, jidx.search_aggregate(base, top_k=5))


def test_retrieval_quality_with_lexical_tokens():
    docs = {
        1: "the rent for the second year is 42800 rupees per month",
        2: "gst tax amount charged on the invoice is 18000",
        3: "weather in paris is mild during spring with rain",
    }
    enc, jenc = HashingEncoder(dim=96), JaxHashingEncoder(dim=96)
    idx, jidx = _pair(96, 32, 64)
    idx.upsert(list(docs), enc.encode_tokens(list(docs.values())))
    jidx.upsert(list(docs), jenc.encode_tokens(list(docs.values())))
    qv = enc.encode_tokens(["what is the gst tax amount"])[0]
    hits = idx.search_aggregate(qv, top_k=3)
    assert hits[0]["child_id"] == 2
    _same_hits(hits, jidx.search_aggregate(qv, top_k=3))


def _pipelines(tmp_path, dim, salt_dense, salt_tok, mv_tokens):
    """The port's and the JAX package's IngestionPipeline, each with a
    multivector tier, on one document."""
    from financial_rag_tpu.index import FlatIndex as JaxFlatIndex
    from financial_rag_tpu.ingest.pipeline import IngestionPipeline as JaxPipeline
    from financial_rag_tpu.models.encoder import DualEncoder as JaxDualEncoder
    from financial_rag_tpu.store import ChildMetaStore as JaxChildMeta
    from financial_rag_tpu.store import ParentStore as JaxParentStore
    from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline
    from financial_rag_tpu_torch.models.encoder import DualEncoder
    from financial_rag_tpu_torch.store import ChildMetaStore, ParentStore

    out = {}
    for tag, (Pipe, Dual, Hash, Flat, Parents, Children, mv) in {
        "port": (IngestionPipeline, DualEncoder, HashingEncoder,
                 lambda: FlatIndex(dim=dim, capacity=1024, device="cpu"), ParentStore,
                 ChildMetaStore, MultiVectorIndex(dim=dim, max_child_tokens=mv_tokens,
                                                  capacity=64, dtype=np.float32, chunk=64,
                                                  device="cpu")),
        "jax": (JaxPipeline, JaxDualEncoder, JaxHashingEncoder,
                lambda: JaxFlatIndex(dim=dim, capacity=1024), JaxParentStore, JaxChildMeta,
                JaxMultiVectorIndex(dim=dim, max_child_tokens=mv_tokens, capacity=64,
                                    dtype=np.float32, chunk=64)),
    }.items():
        d = tmp_path / tag
        d.mkdir()
        enc, tok = Dual({"baai": Hash(dim=dim, salt=salt_dense)}), Hash(dim=dim, salt=salt_tok)
        indexes = {"baai": Flat()}
        pipe = Pipe(enc, Parents(d / "p.db"), Children(d / "c.db"), indexes,
                    multivector_index=mv, token_encoder=tok)
        out[tag] = (pipe, enc, tok, mv, indexes)
    return out


def test_hybrid_with_multivector_tier(tmp_path):
    """Both packages' pipelines ingest the same document into a multivector
    tier; their hybrid retrievers with CHILD_USE_MULTIVECTOR on return the
    same child texts in the same order (child ids are clock-based), the GST
    child first; the tiers hold the same tokens."""
    from financial_rag_tpu.config import RetrievalConfig as JaxRetrievalConfig
    from financial_rag_tpu.retrieval.hybrid import HybridRetriever as JaxHybrid
    from financial_rag_tpu_torch.config import RetrievalConfig
    from financial_rag_tpu_torch.retrieval.hybrid import HybridRetriever

    src = tmp_path / "d.json"
    src.write_text(json.dumps({"blocks": [
        {"content": "The GST amount charged is Rs 18,000 at 18 percent. " * 8, "page": 0},
        {"content": "The lease rent for the second year is Rs 42,800 a month. " * 8,
         "page": 1}]}))
    pipes = _pipelines(tmp_path, 96, 1, 9, 64)
    texts = {}
    for tag, (Hybrid, Cfg) in {"port": (HybridRetriever, RetrievalConfig),
                               "jax": (JaxHybrid, JaxRetrievalConfig)}.items():
        pipe, enc, tok, mv, indexes = pipes[tag]
        pipe.ingest_extracted_json(src, "doc")
        assert mv.count() > 0
        rc = Cfg()
        rc.multivector_enabled = True
        h = Hybrid(enc, indexes, pipe.child_meta, retrieval_cfg=rc, multivector_index=mv,
                   token_encoder=tok)
        chunks, _, _ = h.retrieve_children("what is the gst amount")
        texts[tag] = [c["text"] for c in chunks]
    assert texts["port"] and "GST" in texts["port"][0]
    assert texts["port"] == texts["jax"]
    port_mv, jax_mv = pipes["port"][3], pipes["jax"][3]
    assert port_mv.count() == jax_mv.count()
    np.testing.assert_array_equal(port_mv._tok_mask.numpy(), np.asarray(jax_mv._tok_mask))
    np.testing.assert_allclose(port_mv._tokens.numpy(), np.asarray(jax_mv._tokens),
                               rtol=0, atol=1e-6)


def test_delete(rng):
    idx, jidx = _pair(32, 8, 64)
    vs = [rng.standard_normal((4, 32)).astype(np.float32) for _ in range(6)]
    for index in (idx, jidx):
        index.upsert(np.arange(1, 7, dtype=np.int64), vs)
        assert index.delete([1, 2, 42]) == 2
    assert idx.count() == 4
    q = vs[0] / np.linalg.norm(vs[0], axis=1, keepdims=True)
    hits = idx.search_aggregate(q, top_k=6)
    assert 1 not in [h["child_id"] for h in hits] and len(hits) == 4
    _same_hits(hits, jidx.search_aggregate(q, top_k=6))


def test_remove_document_cleans_multivector(tmp_path):
    src = tmp_path / "d.json"
    src.write_text(json.dumps({"blocks": [
        {"content": "gst amount is 18000 rupees on the invoice. " * 8, "page": 0}]}))
    pipes = _pipelines(tmp_path, 64, 1, 9, 32)
    removed = {}
    for tag, (pipe, _, _, mv, _) in pipes.items():
        pipe.ingest_extracted_json(src, "doc")
        assert mv.count() > 0
        removed[tag] = pipe.remove_document("doc")["vectors_removed"]["multivector"]
        assert mv.count() == 0
    assert removed["port"] == removed["jax"] > 0


def test_growth_and_overwrite(rng):
    idx, jidx = _pair(32, 8, 64)
    vs = [rng.standard_normal((4, 32)).astype(np.float32) for _ in range(100)]
    for index in (idx, jidx):
        index.upsert(np.arange(1, 101, dtype=np.int64), vs)
        index.upsert([1], [-vs[0]])
    assert idx.count() == 100 and idx.capacity == jidx.capacity == 128
    assert idx._tokens.shape == (128, 8, 32) and idx._ids.shape == (128,)
    q = -vs[0] / np.linalg.norm(-vs[0], axis=1, keepdims=True)
    hits = idx.search_aggregate(q, top_k=5)
    assert hits[0]["child_id"] == 1
    _same_hits(hits, jidx.search_aggregate(q, top_k=5))


def test_upsert_after_search_is_visible(rng):
    """tests/test_index_mutation.py's case: an upsert after a search shows
    in the next search, and a delete hides it again."""
    idx = MultiVectorIndex(dim=96, device="cpu")
    idx.upsert(list(range(1, 9)), [_unit(rng, 5, 96) for _ in range(8)])
    idx.search_aggregate(_unit(rng, 3, 96), top_k=4)
    probe = _unit(rng, 4, 96)
    idx.upsert([999], [probe])
    hits = idx.search_aggregate(probe, top_k=4)
    assert hits and hits[0]["child_id"] == 999
    idx.delete([999])
    assert all(h["child_id"] != 999 for h in idx.search_aggregate(probe, top_k=4))


def test_concurrent_upserts_and_searches(rng):
    """8 writer threads upsert 40 children each (growing the index twice)
    while 4 reader threads search, the interpreter switching threads every
    10 us: nothing raises, every child lands, and each child is its own
    token set's best hit afterwards."""
    import sys

    idx = MultiVectorIndex(dim=32, max_child_tokens=4, capacity=64, dtype=np.float32,
                           chunk=64, device="cpu")
    toks = {cid: _unit(rng, 3, 32) for cid in range(1, 321)}
    errors, done = [], threading.Event()

    def writer(w):
        try:
            for cid in range(1 + 40 * w, 41 + 40 * w):
                idx.upsert([cid], [toks[cid]])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    def reader():
        try:
            while not done.is_set():
                for h in idx.search_aggregate(toks[1], top_k=5):
                    assert h["child_id"] in toks
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        writers = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
        readers = [threading.Thread(target=reader) for _ in range(4)]
        for t in writers + readers:
            t.start()
        for t in writers:
            t.join(120)
        done.set()
        for t in readers:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in writers + readers)
    assert not errors, errors
    assert idx.count() == 320 and idx.capacity == 512
    for cid in (1, 77, 160, 320):
        assert idx.search_aggregate(toks[cid], top_k=1)[0]["child_id"] == cid


@pytest.mark.parametrize("dtype", [np.float32, "float32", torch.float32, torch.bfloat16])
def test_storage_dtype_names(dtype):
    want = torch.bfloat16 if dtype is torch.bfloat16 else torch.float32
    assert MultiVectorIndex(dim=8, capacity=8, chunk=8, dtype=dtype,
                            device="cpu")._tokens.dtype == want


def test_storage_dtype_refuses_int8():
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        MultiVectorIndex(dim=8, capacity=8, chunk=8, dtype=np.int8, device="cpu")


# ---------------------------------------------------------- TokenEncoder

TEXTS = [
    "short one",
    "the lock-in period is thirty six months from rent commencement",
    "gst at eighteen percent on the total invoice value of rupees "
    "one lakh eighteen thousand " * 3,
    "a",
    "credit note number and date fields appear on the tax invoice",
    "warehouse lease deposit equals seven lakh rupees",
    "",
]


def _token_encoders():
    from financial_rag_tpu.config import ModelConfig as JaxModelConfig
    from financial_rag_tpu.models.checkpoint import random_params as jax_random_params
    from financial_rag_tpu.models.encoder import Encoder as JaxEncoder
    from financial_rag_tpu.models.encoder import TokenEncoder as JaxTokenEncoder
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.models.encoder import Encoder, TokenEncoder

    fields = dict(name="tiny", hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, vocab_size=30522, max_position=512,
                  type_vocab_size=2, layer_norm_eps=1e-12)
    kw = dict(pooling="mean", batch_size=8, max_seq_len=256)
    cfg, jcfg = ModelConfig(**fields), JaxModelConfig(**fields)
    enc = Encoder(cfg, random_params(cfg, seed=0), device="cpu", **kw)
    jenc = JaxEncoder(jcfg, jax_random_params(jcfg, seed=0), **kw)
    return (TokenEncoder(enc, max_tokens=64, batch_size=4),
            JaxTokenEncoder(jenc, max_tokens=64, batch_size=4))


def test_token_encoder_batched_matches_per_text_and_jax():
    """Length-bucketed batched forwards give per-text calls' ragged shapes
    and values (2e-5), unit rows, and JAX's TokenEncoder's vectors (cosine
    > 0.9999 per token); the empty text falls back to its first row."""
    tok, jtok = _token_encoders()
    assert tok.encoder.params is tok.encoder._params_on[tok.encoder.device]
    batched = tok.encode_tokens(TEXTS)
    single = [tok.encode_tokens([t])[0] for t in TEXTS]
    want = jtok.encode_tokens(TEXTS)
    assert tok.encode_tokens([]) == []
    assert len(batched) == len(TEXTS)
    for b, s, w in zip(batched, single, want):
        assert b.shape == s.shape == w.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, s, atol=2e-5)
        np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-5)
        cos = (b * w).sum(axis=1) / np.linalg.norm(w, axis=1)
        assert cos.min() > 0.9999
    assert batched[-1].shape[0] == 1 and batched[3].shape[0] == 1


def test_token_encoder_feeds_the_index_as_jax_does():
    """The port's TokenEncoder + MultiVectorIndex and the JAX package's give
    the same hits for a token query over the texts."""
    tok, jtok = _token_encoders()
    idx, jidx = _pair(64, 64, 64)
    idx.upsert(np.arange(1, len(TEXTS) + 1), tok.encode_tokens(TEXTS))
    jidx.upsert(np.arange(1, len(TEXTS) + 1), jtok.encode_tokens(TEXTS))
    q = tok.encode_tokens(["the invoice tax credit note"])[0]
    hits = idx.search_aggregate(q, top_k=len(TEXTS))
    want = jidx.search_aggregate(jtok.encode_tokens(["the invoice tax credit note"])[0],
                                 top_k=len(TEXTS))
    assert [h["child_id"] for h in hits] == [h["child_id"] for h in want]
    np.testing.assert_allclose([h["score"] for h in hits], [h["score"] for h in want],
                               rtol=0, atol=1e-4)
