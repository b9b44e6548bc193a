"""The port's cross-request micro-batching (serving/batcher.py) on the CPU.

The cases of tests/test_batcher.py on the port's classes (CPU encoders and
indexes): concurrent requests coalesce into single device calls with
results identical to unbatched ones; the claim protocol, the direct lane
and the static-shape gather. Then the wiring: with the default config the
port's ``Runtime.build`` builds the batchers the JAX package's does.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.models.hashing import HashingEncoder
from financial_rag_tpu_torch.serving.batcher import BatchingEncoder, BatchingIndex, MicroBatcher

torch.set_num_threads(2)


def _run_threads(n, fn):
    results = [None] * n
    errors = []

    def worker(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — surfaced via the errors list
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    return results, errors


def _flat(dim, capacity, name):
    return FlatIndex(dim=dim, capacity=capacity, name=name, device="cpu")


class TestMicroBatcher:
    def test_coalesces_concurrent_submits(self):
        mb = MicroBatcher(lambda xs: [x * 2 for x in xs], max_items=64, max_wait_ms=100.0)
        barrier = threading.Barrier(16)

        def submit(i):
            barrier.wait()
            return mb.submit(i)

        results, errors = _run_threads(16, submit)
        assert not errors
        assert results == [i * 2 for i in range(16)]
        assert mb.submitted == 16
        assert mb.calls < 16, "no coalescing happened"
        mb.close()

    def test_max_items_bounds_fused_call(self):
        seen = []
        mb = MicroBatcher(lambda xs: (seen.append(len(xs)), xs)[1], max_items=4,
                          max_wait_ms=200.0)
        barrier = threading.Barrier(12)
        _, errors = _run_threads(12, lambda i: (barrier.wait(), mb.submit(i))[1])
        assert not errors
        assert max(seen) <= 4
        mb.close()

    def test_exception_propagates_to_all_waiters(self):
        def boom(xs):
            if any(x < 0 for x in xs):
                raise ValueError("kernel exploded")
            return xs

        mb = MicroBatcher(boom, max_wait_ms=50.0)
        barrier = threading.Barrier(4)
        _, errors = _run_threads(4, lambda i: (barrier.wait(), mb.submit(-1 - i))[1])
        assert len(errors) == 4
        assert all("kernel exploded" in str(e) for e in errors)
        assert mb.submit(3) == 3      # the batcher survives a failed batch
        mb.close()

    def test_closed_batcher_rejects(self):
        mb = MicroBatcher(lambda xs: xs)
        mb.close()
        with pytest.raises(RuntimeError):
            mb.submit(1)

    def test_close_race_cannot_fail_a_claimed_slot(self):
        """close() landing while a popped slot's fused call is in flight
        must not let the submit-side closed check overwrite the slot with
        'closed': the dispatcher owns it and its result reaches the waiter."""
        gate = threading.Event()

        def fn_begin(payloads):
            def thunk():
                assert gate.wait(10)
                return [p * 2 for p in payloads]
            return thunk

        mb = MicroBatcher(fn_begin=fn_begin, name="claim-test")
        slot = mb.submit_begin(21)
        for _ in range(500):          # until the worker pops + claims it
            if slot.claimed:
                break
            time.sleep(0.005)
        assert slot.claimed
        mb._closed = True
        assert not slot.fail_if_unclaimed(RuntimeError("closed"))
        assert slot.error is None and not slot.event.is_set()
        gate.set()
        assert slot.wait() == 42      # the dispatched result, not 'closed'
        mb._closed = False
        mb.close()

    def test_slot_claim_protocol_primitives(self):
        from financial_rag_tpu_torch.serving.batcher import _Slot

        err = RuntimeError("closed")
        s = _Slot("p", 1)
        assert s.fail_if_unclaimed(err)       # unclaimed -> failed
        assert s.event.is_set()
        assert not s.claim()                  # dispatcher must then drop it
        with pytest.raises(RuntimeError, match="closed"):
            s.wait()
        s2 = _Slot("p", 1)
        assert s2.claim()
        assert not s2.fail_if_unclaimed(err)  # owned by the dispatcher
        assert s2.error is None and not s2.event.is_set()

    def test_worker_skips_slots_a_failure_path_already_finished(self):
        """A queued slot failed by a failure path is dropped from the
        gather: running it would deliver a result to a waiter that already
        raised."""
        ran = threading.Event()
        gate = threading.Event()
        seen = []

        def fn_begin(payloads):
            seen.append(list(payloads))

            def thunk():
                ran.set()
                assert gate.wait(10)
                return [p for p in payloads]
            return thunk

        # inflight=1: the worker dispatches s1, pops+claims s2, then blocks
        # on the in-flight semaphore; s3 pools in the queue unclaimed
        mb = MicroBatcher(fn_begin=fn_begin, inflight=1, finishers=1, name="skip-test")
        s1 = mb.submit_begin("a")
        assert ran.wait(10)
        s2 = mb.submit_begin("b")
        for _ in range(500):
            if s2.claimed:
                break
            time.sleep(0.005)
        assert s2.claimed
        s3 = mb.submit_begin("c")     # queued, unclaimed
        assert s3.fail_if_unclaimed(RuntimeError("closed"))
        gate.set()                    # worker unblocks, gathers s3, skips it
        assert s1.wait() == "a"
        assert s2.wait() == "b"
        with pytest.raises(RuntimeError, match="closed"):
            s3.wait()
        mb.close()
        assert ["c"] not in seen and ["b", "c"] not in seen


class _CountingEncoder(HashingEncoder):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.n_calls = 0

    def encode(self, texts):
        self.n_calls += 1
        return super().encode(texts)


class TestBatchingEncoder:
    def test_results_match_unbatched(self):
        inner = _CountingEncoder(dim=64)
        batched = BatchingEncoder(inner, max_wait_ms=100.0)
        texts = [[f"query {i} about rent", f"variant {i}"] for i in range(8)]
        expected = [HashingEncoder(dim=64).encode(t) for t in texts]

        barrier = threading.Barrier(8)
        results, errors = _run_threads(8, lambda i: (barrier.wait(), batched.encode(texts[i]))[1])
        assert not errors
        for got, want in zip(results, expected):
            np.testing.assert_allclose(got, want, atol=1e-6)
        assert inner.n_calls < 8, "encode calls were not coalesced"

    def test_delegation_and_empty(self):
        inner = _CountingEncoder(dim=64)
        batched = BatchingEncoder(inner)
        assert batched.dim == 64            # attribute passthrough
        assert batched.encode([]).shape == (0, 64)
        v = batched.encode_one("hello world")
        assert v.shape == (64,)


class TestBatchingIndex:
    @pytest.fixture()
    def corpus(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((512, 64)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return x

    def test_search_matches_unbatched(self, corpus):
        inner = _flat(64, 1024, "mb_t")
        inner.upsert(np.arange(1, 513, dtype=np.int64), corpus)
        batched = BatchingIndex(inner, max_wait_ms=100.0)

        rng = np.random.default_rng(1)
        queries = [corpus[rng.integers(0, 512, 3)] for _ in range(8)]
        expected = [inner.search(q, 5) for q in queries]

        barrier = threading.Barrier(8)
        results, errors = _run_threads(
            8, lambda i: (barrier.wait(), batched.search(queries[i], 5))[1])
        assert not errors
        for (gi, gs), (wi, ws) in zip(results, expected):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=1e-5)
        stats = batched.stats()
        assert stats["k5"]["submitted"] == 8
        assert stats["k5"]["calls"] < 8, "searches were not coalesced"

    def test_different_k_batched_separately(self, corpus):
        inner = _flat(64, 1024, "mb_k")
        inner.upsert(np.arange(1, 513, dtype=np.int64), corpus)
        batched = BatchingIndex(inner, max_wait_ms=20.0)
        q = corpus[:2]
        ids5, _ = batched.search(q, 5)
        ids9, _ = batched.search(q, 9)
        assert ids5.shape == (2, 5) and ids9.shape == (2, 9)
        assert set(batched.stats()) == {"k5", "k9"}

    def test_mutations_pass_through_and_len(self, corpus):
        inner = _flat(64, 1024, "mb_m")
        batched = BatchingIndex(inner)
        batched.upsert(np.arange(1, 513, dtype=np.int64), corpus)
        assert batched.count() == 512
        assert len(batched) == 512
        batched.delete([1, 2, 3])
        assert batched.count() == 509
        # post-mutation search sees the change (1-D query also accepted)
        ids, _ = batched.search(corpus[0], 5)
        assert 1 not in ids[0]


class TestMultiIndexBatcher:
    """Hybrid-level sweep batching: both per-model indexes' sweeps fuse
    into one launch each and one combined device-to-host copy per batch."""

    @pytest.fixture()
    def indexes(self):
        rng = np.random.default_rng(0)
        out = {}
        for name in ("baai", "gte"):
            x = rng.standard_normal((256, 64)).astype(np.float32)
            x /= np.linalg.norm(x, axis=1, keepdims=True)
            idx = _flat(64, 512, f"mib_{name}")
            idx.upsert(np.arange(1, 257, dtype=np.int64), x)
            out[name] = (idx, x)
        return out

    def test_concurrent_sweeps_match_unbatched(self, indexes):
        from financial_rag_tpu_torch.serving.batcher import MultiIndexBatcher

        raw = {n: idx for n, (idx, _) in indexes.items()}
        mib = MultiIndexBatcher(raw, max_queries=64)
        rng = np.random.default_rng(1)
        reqs = [{n: x[rng.integers(0, 256, 3)] for n, (_, x) in indexes.items()}
                for _ in range(8)]
        expected = [{n: raw[n].search(vecs, 5) for n, vecs in r.items()} for r in reqs]

        barrier = threading.Barrier(8)
        results, errors = _run_threads(
            8, lambda i: (barrier.wait(), mib.search_all(reqs[i], 5))[1])
        assert not errors
        for got, want in zip(results, expected):
            for n in raw:
                np.testing.assert_array_equal(got[n][0], want[n][0])
                np.testing.assert_allclose(got[n][1], want[n][1], rtol=1e-5)
        stats = mib.stats()
        assert stats["k5"]["submitted"] == 8
        assert stats["k5"]["calls"] < 8, "sweeps were not coalesced"


class TestRuntimeMicrobatch:
    def test_engine_query_through_batched_stack(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SERVE_MICROBATCH", "1")
        monkeypatch.setenv("MICROBATCH_WAIT_MS", "5")
        from financial_rag_tpu_torch.config import FrameworkConfig
        from financial_rag_tpu_torch.runtime import Runtime
        from financial_rag_tpu_torch.serving.batcher import MultiIndexBatcher

        rt = Runtime.build(FrameworkConfig.from_env(), data_dir=tmp_path, device="cpu")
        # sweep batching lives at the hybrid level; the indexes stay raw
        assert isinstance(rt.hybrid.sweep_batcher, MultiIndexBatcher)
        assert all(isinstance(i, FlatIndex) for i in rt.indexes.values())
        src = tmp_path / "lease.json"
        src.write_text(json.dumps({"blocks": [
            {"content": "The second year rent is 42,800 per month.", "page": 1},
            {"content": "The lock-in period is 36 months.", "page": 2},
        ]}))
        rt.pipeline.ingest_extracted_json(src, "lease")
        barrier = threading.Barrier(4)
        results, errors = _run_threads(
            4, lambda i: (barrier.wait(), rt.engine.query(f"what is the rent? v{i}"))[1])
        assert not errors
        for r in results:
            assert r["success"]
            assert r["top_children_chunks"], "retrieval returned nothing"


class TestAdaptiveDirectLane:
    """At or below `direct` concurrent requests a submission dispatches in
    its own thread; above, submissions coalesce. Gated on a runtime-wide
    ActiveCount the engine brackets around each request."""

    def test_low_concurrency_goes_direct(self):
        calls = []

        def begin(groups):
            calls.append(len(groups))
            return lambda: [g * 2 for g in groups]

        mb = MicroBatcher(fn_begin=begin, direct=8)
        # sequential submits: active (private gauge) stays at 1 <= 8
        for i in range(5):
            assert mb.submit(i) == i * 2
        assert mb.direct_calls == 5
        assert mb.calls == 0, "low concurrency must bypass the dispatcher"
        mb.close()

    def test_above_limit_coalesces(self):
        from financial_rag_tpu_torch.serving.batcher import ActiveCount

        gauge = ActiveCount()

        def begin(groups):
            return lambda: [g * 2 for g in groups]

        mb = MicroBatcher(fn_begin=begin, direct=2, active=gauge)
        for _ in range(5):            # engine-style bracketing above the limit
            gauge.enter()
        barrier = threading.Barrier(8)
        results, errors = _run_threads(8, lambda i: (barrier.wait(), mb.submit(i))[1])
        assert not errors and results == [i * 2 for i in range(8)]
        assert mb.direct_calls == 0, "above the limit nothing may go direct"
        assert mb.calls >= 1 and mb.submitted == 8
        for _ in range(5):
            gauge.leave()
        mb.close()

    def test_gather_never_overshoots_max_items(self):
        from financial_rag_tpu_torch.serving.batcher import ActiveCount

        gauge = ActiveCount()
        sizes = []

        def begin(groups):
            sizes.append(sum(len(g) for g in groups))
            return lambda: [g for g in groups]

        mb = MicroBatcher(fn_begin=begin, max_items=10, direct=0, active=gauge)
        for _ in range(99):
            gauge.enter()
        barrier = threading.Barrier(12)
        # weight-3 payloads: 3 fit in a 10-row batch; the 4th would
        # overshoot and must carry to the next batch
        _, errors = _run_threads(12, lambda i: (barrier.wait(), mb.submit([i] * 3, weight=3))[1])
        assert not errors
        assert max(sizes) <= 10, f"fused batch overshot the static shape: {sizes}"
        assert sum(sizes) == 36
        mb.close()

    def test_rerank_batching_matches_unbatched(self):
        from financial_rag_tpu_torch.config import ModelConfig
        from financial_rag_tpu_torch.models.checkpoint import random_params
        from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderModel
        from financial_rag_tpu_torch.serving.batcher import BatchingCrossEncoder

        cfg = ModelConfig(name="ce-t", hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=128, vocab_size=30522, max_position=128,
                          num_labels=1)
        inner = CrossEncoderModel(cfg, random_params(cfg, seed=3), max_seq_len=128,
                                  device="cpu")
        wrapped = BatchingCrossEncoder(inner, max_pairs=64, direct=0)

        pair_sets = [
            [("what is the rent", f"the rent is {i} rupees"),
             ("who is the lessor", f"lessor number {i} is named")]
            for i in range(6)
        ]
        expected = [inner.predict(ps) for ps in pair_sets]
        barrier = threading.Barrier(6)
        results, errors = _run_threads(
            6, lambda i: (barrier.wait(), wrapped.predict(pair_sets[i]))[1])
        assert not errors
        for got, exp in zip(results, expected):
            np.testing.assert_allclose(got, exp, rtol=2e-3, atol=2e-3)
        assert wrapped.stats()["submitted"] == 6
        wrapped.batcher.close()


# ------------------------------------------------------------------ wiring

def _wiring(rt, batcher_mod):
    """What Runtime.build wired around each component, by class name, and
    whether every batcher shares the engine's one ActiveCount."""
    enc = rt.dual_encoder.encoders
    sweep = rt.hybrid.sweep_batcher
    rerank = rt.engine.reranker.model
    llm = rt.engine.llm
    gauge = rt.engine.active
    gauges = ([e.batcher._active for e in enc.values()] + [sweep.active, rerank.batcher._active,
                                                           llm._active])
    return {
        "active": type(gauge).__name__,
        "encoders": {n: type(e).__name__ for n, e in enc.items()},
        "encoder_inner": {n: type(e.inner).__name__ for n, e in enc.items()},
        "sweep": type(sweep).__name__,
        "chain_encoders": {n: type(e).__name__ for n, e in sweep.chain_encoder.encoders.items()},
        "chain_shares_cache": sweep.chain_encoder.cache is rt.dual_encoder.cache,
        "rerank": type(rerank).__name__,
        "rerank_max_pairs": rerank.batcher.max_items,
        "llm": type(llm).__name__,
        "llm_inner": type(llm.inner).__name__,
        "one_gauge": all(g is gauge for g in gauges),
        "limits": (sweep.max_queries, sweep.direct, sweep.inflight),
    }


def test_default_config_wires_the_jax_runtimes_batchers(tmp_path, monkeypatch):
    """SERVE_MICROBATCH's default: both packages' Runtime.build wire one
    ActiveCount, a BatchingEncoder per device-backed encoder, a
    MultiIndexBatcher with a raw-encoder chain lane on the serving cache, a
    BatchingCrossEncoder (128 pairs) and a BatchingLLM around a local LLM."""
    from financial_rag_tpu.config import FrameworkConfig as JaxFrameworkConfig
    from financial_rag_tpu.runtime import Runtime as JaxRuntime
    from financial_rag_tpu.serving import batcher as jbatcher
    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.serving import batcher as tbatcher
    from test_torch_slice import _write_checkpoint

    for var in ("SERVE_MICROBATCH", "MICROBATCH_DIRECT", "MICROBATCH_MAX",
                "MICROBATCH_INFLIGHT", "FRAG_PLATFORM"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    ckpt = tmp_path / "ckpt"
    for name, seed, clf in (("bge", 1, False), ("gte", 2, False), ("ce", 3, True)):
        _write_checkpoint(ckpt / name, seed=seed, classifier=clf)

    def config(cls):
        cfg = cls()
        cfg.encoders.baai_path = str(ckpt / "bge")
        cfg.encoders.gte_path = str(ckpt / "gte")
        cfg.rerank.model_path = str(ckpt / "ce")
        cfg.llm.provider, cfg.llm.local_checkpoint = "local", str(tmp_path / "no_llm_yet")
        assert cfg.serving.microbatch and cfg.serving.microbatch_direct == 32
        return cfg

    jrt = JaxRuntime.build(config(JaxFrameworkConfig), data_dir=tmp_path / "jax")
    trt = Runtime.build(config(FrameworkConfig), data_dir=tmp_path / "port", device="cpu")
    want, got = _wiring(jrt, jbatcher), _wiring(trt, tbatcher)
    assert got == want
    assert got["encoders"] == {"baai": "BatchingEncoder", "gte": "BatchingEncoder"}
    assert got["llm"] == "BatchingLLM" and got["one_gauge"]
    assert got["limits"] == (192, 32, 4)
    assert isinstance(trt.engine.active, tbatcher.ActiveCount)
