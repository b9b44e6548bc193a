"""The port's continuous-batching decode engine (llm/continuous.py) on the CPU.

The cases of tests/test_continuous.py on the port: a stream that JOINS the
shared batched decode mid-flight emits exactly the tokens of the port's
batch-1 greedy ``generate_tokens`` (trimmed at eos), in f32; admission
control, window reset on drain, and the serving routing (BatchingLLM's
direct lane below its limit, the engine above). Then parity with the JAX
package's engine on the same numpy weights (identical tokens, f32), and
``_verify_block_rows`` against the JAX function (logits within 1e-5) and
with its rows' left padding masked.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from financial_rag_tpu.llm import continuous as jcont
from financial_rag_tpu.models import decoder as jdec
from financial_rag_tpu_torch.llm.continuous import ContinuousDecodeEngine
from financial_rag_tpu_torch.models import decoder as tdec

torch.set_num_threads(2)

TINY = dict(vocab_size=97, num_layers=2, hidden_size=32, num_heads=4, num_kv_heads=2,
            intermediate_size=64, eos_token_id=5, attention_bias=True)


def _prompt(rng, cfg, s_real, bucket):
    ids = np.full((1, bucket), cfg.eos_token_id, np.int32)
    mask = np.zeros((1, bucket), np.int32)
    toks = rng.integers(6, cfg.vocab_size, size=s_real).astype(np.int32)
    ids[0, bucket - s_real:] = toks
    mask[0, bucket - s_real:] = 1
    return ids, mask


def _reference(params, cfg, ids, mask, cap):
    """The port's batch-1 greedy tokens, trimmed at eos, capped at `cap`."""
    toks = tdec.generate_tokens(params, ids, mask, cfg=cfg, max_new_tokens=cap,
                                temperature=0.0)[0].tolist()
    if cfg.eos_token_id in toks:
        toks = toks[: toks.index(cfg.eos_token_id)]
    return toks


def _drain(it):
    out = []
    for block in it:
        assert block.ndim == 2 and block.shape[0] == 1
        out.extend(block[0].tolist())
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port params) from one init."""
    jcfg = jdec.DecoderConfig(**TINY)
    jp = jdec.random_decoder_params(jcfg, seed=11)
    tp = tdec.decoder_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tdec.DecoderConfig(**TINY), tp


@pytest.fixture(scope="module")
def setup(pair):
    return pair[2], pair[3]


class TestEngineParity:
    def test_solo_stream_matches_batch1_greedy(self, setup):
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=4, t_prompt=16, window=32, segment=4)
        try:
            rng = np.random.default_rng(0)
            ids, mask = _prompt(rng, cfg, s_real=9, bucket=16)
            got = _drain(eng.submit(ids, mask, 12))
            assert got == _reference(params, cfg, ids, mask, 12)
            assert eng.stats()["joins"] == 1
        finally:
            eng.close()

    def test_staggered_join_matches_each_solo_reference(self, setup):
        """A stream that joins while another is mid-generation emits the
        same tokens as its own batch-1 run: the shared cache layout, the
        per-row masks and the per-row rotary positions leak nothing."""
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=4, t_prompt=16, window=64, segment=4)
        try:
            rng = np.random.default_rng(1)
            ids_a, mask_a = _prompt(rng, cfg, s_real=12, bucket=16)
            ids_b, mask_b = _prompt(rng, cfg, s_real=5, bucket=8)
            it_a = eng.submit(ids_a, mask_a, 20)
            first_a = next(it_a)                 # A is live before B joins
            it_b = eng.submit(ids_b, mask_b, 20)
            got_a = first_a[0].tolist() + _drain(it_a)
            got_b = _drain(it_b)
            assert got_a == _reference(params, cfg, ids_a, mask_a, 20)
            assert got_b == _reference(params, cfg, ids_b, mask_b, 20)
            assert eng.stats()["joins"] == 2
        finally:
            eng.close()

    def test_many_concurrent_streams(self, setup):
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=4, t_prompt=16, window=96, segment=4)
        try:
            rng = np.random.default_rng(2)
            prompts = [_prompt(rng, cfg, s_real=4 + i, bucket=16) for i in range(4)]
            its = [eng.submit(ids, mask, 10) for ids, mask in prompts]
            for (ids, mask), it in zip(prompts, its):
                assert _drain(it) == _reference(params, cfg, ids, mask, 10)
        finally:
            eng.close()


class TestSpeculativeBlocks:
    def test_spec_engine_matches_greedy_reference(self, setup):
        """Speculative blocks (prompt-lookup drafts + shared verify) emit
        exactly the greedy token sequence; the window is sized so spec
        blocks actually run."""
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=4, t_prompt=16, window=128, segment=4,
                                     spec_k=4)
        try:
            rng = np.random.default_rng(20)
            ids, mask = _prompt(rng, cfg, s_real=10, bucket=16)
            got = _drain(eng.submit(ids, mask, 24))
            assert got == _reference(params, cfg, ids, mask, 24)
            st = eng.stats()
            assert st["spec_blocks"] > 0, f"spec never engaged: {st}"
        finally:
            eng.close()

    def test_spec_staggered_join_parity(self, setup):
        """A stream that joins while spec blocks run still emits its own
        batch-1 greedy sequence: rejected-slot masking and per-row draft
        histories leak nothing across rows."""
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=4, t_prompt=16, window=256, segment=4,
                                     spec_k=4)
        try:
            rng = np.random.default_rng(21)
            ids_a, mask_a = _prompt(rng, cfg, s_real=12, bucket=16)
            ids_b, mask_b = _prompt(rng, cfg, s_real=6, bucket=8)
            it_a = eng.submit(ids_a, mask_a, 20)
            first_a = next(it_a)
            it_b = eng.submit(ids_b, mask_b, 20)
            got_a = first_a[0].tolist() + _drain(it_a)
            got_b = _drain(it_b)
            assert got_a == _reference(params, cfg, ids_a, mask_a, 20)
            assert got_b == _reference(params, cfg, ids_b, mask_b, 20)
            assert eng.stats()["spec_blocks"] > 0
        finally:
            eng.close()

    def test_spec_falls_back_to_greedy_near_window_end(self, setup):
        """When one more spec block could strand a live row the engine
        finishes on greedy segments, with the exact greedy tokens."""
        cfg, params = setup
        # window 24, cap 20, blk 6: after at most one spec block the
        # remaining slots force the greedy tail
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=24, segment=4,
                                     spec_k=5)
        try:
            rng = np.random.default_rng(22)
            ids, mask = _prompt(rng, cfg, s_real=8, bucket=8)
            got = _drain(eng.submit(ids, mask, 20))
            assert got == _reference(params, cfg, ids, mask, 20)
            st = eng.stats()
            assert st["segments"] > 0, f"greedy tail never ran: {st}"
        finally:
            eng.close()

    def test_spec_zero_disables(self, setup):
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=32, segment=4,
                                     spec_k=0)
        try:
            assert eng._spec_fn is None
            rng = np.random.default_rng(23)
            ids, mask = _prompt(rng, cfg, s_real=6, bucket=8)
            got = _drain(eng.submit(ids, mask, 12))
            assert got == _reference(params, cfg, ids, mask, 12)
            assert eng.stats()["spec_blocks"] == 0
        finally:
            eng.close()


class TestHardening:
    def test_window_rounds_down_to_segment_multiple(self, setup):
        """A window that is not a segment multiple is rounded down, so the
        last segment never writes cache slots past t_total."""
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=18, segment=4)
        try:
            assert eng.window == 16
            assert eng.t_total == 32
            rng = np.random.default_rng(9)
            ids, mask = _prompt(rng, cfg, s_real=6, bucket=8)
            got = _drain(eng.submit(ids, mask, 16))
            assert got == _reference(params, cfg, ids, mask, 16)
        finally:
            eng.close()

    def test_prefill_failure_fails_one_stream_not_engine(self, setup):
        """A joiner whose prefill raises fails only its own stream; the
        worker stays alive and later submissions stream normally."""
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=32, segment=4)
        try:
            def boom(bucket):
                def fn(*a, **k):
                    raise ValueError("transient prefill failure")
                return fn
            real = eng._prefill_for
            eng._prefill_for = boom
            rng = np.random.default_rng(10)
            ids, mask = _prompt(rng, cfg, s_real=6, bucket=8)
            it = eng.submit(ids, mask, 8)
            assert it is not None
            with pytest.raises(RuntimeError):
                _drain(it)
            eng._prefill_for = real
            got = _drain(eng.submit(ids, mask, 8))
            assert got == _reference(params, cfg, ids, mask, 8)
        finally:
            eng.close()

    def test_window_race_raises_typed_error_before_first_token(self, setup):
        from financial_rag_tpu_torch.llm.continuous import _REJECTED, WindowRacedError, _Stream

        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=32, segment=4)
        try:
            s = _Stream(cap=8)
            s.q.put(_REJECTED)
            with pytest.raises(WindowRacedError):
                next(eng._iter_blocks(s))
        finally:
            eng.close()


class TestAdmission:
    def test_oversize_cap_and_prompt_rejected(self, setup):
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=8, segment=4)
        try:
            rng = np.random.default_rng(3)
            ids, mask = _prompt(rng, cfg, s_real=4, bucket=8)
            assert eng.submit(ids, mask, 9) is None      # cap > window
            wide, wmask = _prompt(rng, cfg, s_real=20, bucket=32)
            assert eng.submit(wide, wmask, 4) is None    # prompt > t_prompt
        finally:
            eng.close()

    def test_window_resets_after_drain(self, setup):
        """Spend most of the window, drain, then a fresh request is
        admitted again (the write head resets for free on empty)."""
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=16, segment=4)
        try:
            rng = np.random.default_rng(4)
            ids, mask = _prompt(rng, cfg, s_real=6, bucket=8)
            for _ in range(3):                   # each spends 12 of 16 slots
                got = _drain(eng.submit(ids, mask, 12))
                assert got == _reference(params, cfg, ids, mask, 12)
        finally:
            eng.close()

    def test_close_fails_live_streams_loudly(self, setup):
        cfg, params = setup
        eng = ContinuousDecodeEngine(params, cfg, rows=2, t_prompt=16, window=64, segment=4)
        rng = np.random.default_rng(5)
        ids, mask = _prompt(rng, cfg, s_real=6, bucket=8)
        it = eng.submit(ids, mask, 40)
        next(it)                                  # stream is live
        eng.close()
        with pytest.raises(RuntimeError):
            for _ in it:
                pass


class TestLocalLLMIntegration:
    @pytest.fixture(scope="class")
    def llm(self, tmp_path_factory):
        import tokenizers
        import transformers
        from tokenizers import models as tok_models, pre_tokenizers

        d = tmp_path_factory.mktemp("cont_llm")
        torch.manual_seed(3)
        hf = transformers.Qwen2Config(
            vocab_size=256, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=64, tie_word_embeddings=True,
            eos_token_id=250, bos_token_id=250)
        with torch.no_grad():
            transformers.Qwen2ForCausalLM(hf).save_pretrained(str(d))
        vocab = {f"w{i}": i for i in range(240)}
        vocab.update({"<unk>": 240, "<|im_start|>": 241, "<|im_end|>": 242,
                      "user": 243, "assistant": 244})
        tok = tokenizers.Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        tok.save(str(d / "tokenizer.json"))
        (d / "tokenizer_config.json").write_text(json.dumps(
            {"chat_template": "{% for m in messages %}<|im_start|>...{% endfor %}"}))

        from financial_rag_tpu_torch.config import LLMConfig
        from financial_rag_tpu_torch.llm.local_llm import LocalLLM
        cfg = LLMConfig(local_checkpoint=str(d), local_max_new_tokens=16,
                        local_continuous_rows=4, local_continuous_window=64)
        llm = LocalLLM(cfg, model_dir=str(d), dtype="float32", max_prompt_tokens=128,
                       device="cpu")
        yield llm
        if llm._engine is not None:
            llm._engine.close()

    def test_engine_text_matches_per_request_stream(self, llm):
        prompt = "w1 w2 w3 what is the rent"
        via = llm.stream_via_engine(prompt, max_tokens=12)
        assert via is not None
        engine_text = "".join(via)
        stream_text = "".join(llm.generate_stream(prompt, max_tokens=12))
        assert engine_text == stream_text

    def test_engine_disabled_returns_none(self, llm):
        old = llm.cfg.local_continuous_rows
        llm.cfg.local_continuous_rows = 0
        try:
            assert llm.stream_via_engine("w1 w2", max_tokens=4) is None
        finally:
            llm.cfg.local_continuous_rows = old

    def test_batching_llm_routes_by_concurrency(self, llm):
        from financial_rag_tpu_torch.serving.batcher import ActiveCount, BatchingLLM

        prompt = "w5 w6 w7 total amount due"
        want = "".join(llm.generate_stream(prompt, max_tokens=8))

        gauge = ActiveCount()
        wrapped = BatchingLLM(llm, direct=2, active=gauge)
        # below the threshold: the per-request path, no engine involvement
        low = "".join(wrapped.generate_stream(prompt, max_tokens=8))
        assert low == want and wrapped.engine_streams == 0
        # above it: the engine path, same text
        for _ in range(3):
            gauge.enter()
        try:
            high = "".join(wrapped.generate_stream(prompt, max_tokens=8))
        finally:
            for _ in range(3):
                gauge.leave()
        assert high == want and wrapped.engine_streams == 1

    def test_window_race_falls_back_to_per_request_stream(self, llm):
        """A stream whose engine admission races away before the first
        token silently falls back to the inner per-request stream."""
        from financial_rag_tpu_torch.llm.continuous import WindowRacedError
        from financial_rag_tpu_torch.serving.batcher import ActiveCount, BatchingLLM

        prompt = "w8 w9 the lock in period"
        want = "".join(llm.generate_stream(prompt, max_tokens=8))

        def raced(prompt, *, max_tokens):
            def gen():
                raise WindowRacedError("window exhausted")
                yield  # pragma: no cover
            return gen()

        gauge = ActiveCount()
        wrapped = BatchingLLM(llm, direct=1, active=gauge)
        wrapped.inner.stream_via_engine = raced
        for _ in range(2):
            gauge.enter()
        try:
            got = "".join(wrapped.generate_stream(prompt, max_tokens=8))
        finally:
            for _ in range(2):
                gauge.leave()
            del wrapped.inner.stream_via_engine
        assert got == want and wrapped.engine_streams == 1

    def test_owned_gauge_streams_see_each_other(self, llm):
        """In owned-gauge mode a second stream opened while the first is
        still being consumed routes via the engine."""
        from financial_rag_tpu_torch.serving.batcher import BatchingLLM

        prompt = "w10 w11 gst amount"
        want = "".join(llm.generate_stream(prompt, max_tokens=8))

        wrapped = BatchingLLM(llm, direct=1)       # no gauge passed: owned
        g1 = wrapped.generate_stream(prompt, max_tokens=8)
        first = next(g1)                           # g1 holds the gauge now
        high = "".join(wrapped.generate_stream(prompt, max_tokens=8))
        rest = "".join(g1)
        assert first + rest == want
        assert high == want and wrapped.engine_streams == 1


# ------------------------------------------------- against the JAX package

@pytest.mark.parametrize("spec_k,window", [(0, 64), (4, 128)], ids=["segments", "spec"])
def test_engine_matches_jax_engine(pair, spec_k, window):
    """The same staggered pair of streams through both packages' engines on
    the same numpy weights gives identical tokens (f32)."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(30)
    ids_a, mask_a = _prompt(rng, tcfg, s_real=11, bucket=16)
    ids_b, mask_b = _prompt(rng, tcfg, s_real=5, bucket=8)
    got = {}
    for tag, eng in (("jax", jcont.ContinuousDecodeEngine(jp, jcfg, rows=4, t_prompt=16,
                                                          window=window, segment=4,
                                                          spec_k=spec_k)),
                     ("port", ContinuousDecodeEngine(tp, tcfg, rows=4, t_prompt=16,
                                                     window=window, segment=4,
                                                     spec_k=spec_k))):
        try:
            it_a = eng.submit(ids_a, mask_a, 20)
            first_a = next(it_a)
            it_b = eng.submit(ids_b, mask_b, 20)
            got[tag] = (first_a[0].tolist() + _drain(it_a), _drain(it_b),
                        eng.stats()["spec_blocks"] > 0)
        finally:
            eng.close()
    assert got["port"][:2] == got["jax"][:2]
    assert got["port"][2] == got["jax"][2] == (spec_k > 0)
    assert got["port"][0] == _reference(tp, tcfg, ids_a, mask_a, 20)


def _rows_inputs(cfg, seed):
    """A two-row shared-write-head cache: each row's left-padded prompt
    prefilled into it at its own offset behind the write head w."""
    rng = np.random.default_rng(seed)
    t_total, w = 48, 24
    ids = [_prompt(rng, cfg, s_real=n, bucket=16) for n in (9, 14)]
    return rng, t_total, w, ids


def _port_rows_cache(tp, tcfg, t_total, w, ids):
    L, kv, d = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    kc = torch.zeros((L, 2, t_total, kv, d))
    vc = torch.zeros_like(kc)
    pm = torch.zeros((2, t_total), dtype=torch.bool)
    pos = []
    for row, (p_ids, p_mask) in enumerate(ids):
        s = p_ids.shape[1]
        _, k_seq, v_seq = tdec._prefill(tp, torch.from_numpy(p_ids).long(),
                                        torch.from_numpy(p_mask), s, tcfg)
        kc[:, row, w - s:w] = k_seq[:, 0]
        vc[:, row, w - s:w] = v_seq[:, 0]
        pm[row, w - s:w] = torch.from_numpy(p_mask[0].astype(bool))
        pm[row, w:] = True
        pos.append(int(p_mask.sum()))
    return kc, vc, pm, torch.tensor(pos)


def test_verify_block_rows_matches_jax(pair):
    """Two rows at different rotary positions, one shared write slot: the
    port's logits within 1e-5 of the JAX function's on the same cache."""
    jcfg, jp, tcfg, tp = pair
    rng, t_total, w, ids = _rows_inputs(tcfg, 31)
    kc, vc, pm, pos = _port_rows_cache(tp, tcfg, t_total, w, ids)
    toks = rng.integers(6, tcfg.vocab_size, (2, 5)).astype(np.int32)
    want, _, _ = jdec._verify_block_rows(
        jp, jnp.asarray(toks), jnp.asarray(pos.numpy().astype(np.int32)), jnp.int32(w),
        jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()), jnp.asarray(pm.numpy()), jcfg)
    got = tdec._verify_block_rows(tp, torch.from_numpy(toks).long(), pos, w, kc, vc, pm, tcfg)
    assert got.shape == (2, 5, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # each row equals its own batch-1 _verify_block
    for row in range(2):
        one = tdec._verify_block(tp, torch.from_numpy(toks[row:row + 1]).long(),
                                 int(pos[row]), w, kc[:, row:row + 1].clone(),
                                 vc[:, row:row + 1].clone(), pm[row:row + 1], tcfg)
        np.testing.assert_allclose(got[row].numpy(), one.numpy(), atol=1e-5, rtol=1e-5)


def test_verify_block_rows_masks_left_padding(pair):
    """K9 writes zeros in a prompt's left-padding rows where the JAX kernel
    writes the mean of V, so the k/v the two packages cache at padding
    slots differ. The prompt mask keeps them out of attention: garbage
    written there leaves the logits bit-identical, and the same garbage
    with the padding unmasked (the control) changes them."""
    _, _, tcfg, tp = pair
    rng, t_total, w, ids = _rows_inputs(tcfg, 32)
    kc, vc, pm, pos = _port_rows_cache(tp, tcfg, t_total, w, ids)
    toks = torch.from_numpy(rng.integers(6, tcfg.vocab_size, (2, 4))).long()
    clean = tdec._verify_block_rows(tp, toks, pos, w, kc.clone(), vc.clone(), pm, tcfg)
    pad = torch.zeros((2, t_total), dtype=torch.bool)
    for row, (p_ids, p_mask) in enumerate(ids):
        s = p_ids.shape[1]
        pad[row, w - s:w] = torch.from_numpy(p_mask[0] == 0)
    assert int(pad.sum()) == (16 - 9) + (16 - 14)
    kg, vg = kc.clone(), vc.clone()
    g = torch.Generator().manual_seed(0)
    for row in range(2):
        slots = pad[row].nonzero()[:, 0]
        kg[:, row, slots] = 50.0 * torch.randn(kg[:, row, slots].shape, generator=g)
        vg[:, row, slots] = 50.0 * torch.randn(vg[:, row, slots].shape, generator=g)
    garbage = tdec._verify_block_rows(tp, toks, pos, w, kg.clone(), vg.clone(), pm, tcfg)
    assert torch.equal(garbage, clean)
    unmasked = tdec._verify_block_rows(tp, toks, pos, w, kg, vg, pm | pad, tcfg)
    assert (unmasked - clean).abs().max() > 1e-2


def test_segment_past_the_window_end_matches_jax_engine(pair):
    """Speculative blocks of spec_k + 1 = 8 slots move the write head off
    the 16-slot segment grid, so the greedy segment that finishes the rows
    starts within 16 slots of the window's end: its slots past the end are
    clamped as JAX clamps them, and the streams finish as JAX's do."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(31)
    ids_a, mask_a = _prompt(rng, tcfg, s_real=11, bucket=16)
    ids_b, mask_b = _prompt(rng, tcfg, s_real=5, bucket=8)
    got = {}
    for tag, eng in (("jax", jcont.ContinuousDecodeEngine(jp, jcfg, rows=4, t_prompt=16,
                                                          window=64, segment=16, spec_k=7)),
                     ("port", ContinuousDecodeEngine(tp, tcfg, rows=4, t_prompt=16,
                                                     window=64, segment=16, spec_k=7))):
        try:
            it_a = eng.submit(ids_a, mask_a, 24)
            first_a = next(it_a)
            it_b = eng.submit(ids_b, mask_b, 24)
            got[tag] = (first_a[0].tolist() + _drain(it_a), _drain(it_b), eng.stats())
        finally:
            eng.close()
    assert got["port"][:2] == got["jax"][:2]
    assert len(got["port"][0]) == len(got["port"][1]) == 24
    assert got["port"][2]["spec_blocks"] > 0 and got["port"][2]["segments"] > 0
