"""The port's decoder (models/decoder.py) and K9's plain version against the
JAX package on the CPU.

The same numpy inputs (weights from the JAX package's numpy-seeded init,
prompts from numpy) go through both packages in f32. Logits agree within
1e-5; greedy tokens are identical for the plain, speculative and streaming
generators, in the split layout and in the int8 + fused serving layout,
at heads of 8 to 16 and of 128. K9's Pallas kernel runs in interpret mode,
as the JAX package's own tests run it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from financial_rag_tpu.models import decoder as jdec
from financial_rag_tpu.ops.causal_flash import causal_flash_prefill as jax_causal_flash
from financial_rag_tpu_torch.models import decoder as tdec
from financial_rag_tpu_torch.ops import causal_flash as k9

torch.set_num_threads(2)

QWEN2 = dict(vocab_size=211, hidden_size=64, intermediate_size=128, num_layers=3,
             num_heads=4, num_kv_heads=2, rope_theta=10000.0, norm_eps=1e-6,
             attention_bias=True, tie_embeddings=False, eos_token_id=5)
LLAMA = dict(vocab_size=173, hidden_size=48, intermediate_size=96, num_layers=2,
             num_heads=4, num_kv_heads=4, rope_theta=10000.0, norm_eps=1e-5,
             attention_bias=False, tie_embeddings=True, eos_token_id=3)
SMALL = dict(vocab_size=97, num_layers=2, hidden_size=32, num_heads=4, num_kv_heads=2,
             intermediate_size=64, attention_bias=True, tie_embeddings=True, eos_token_id=0)
TINY_EOS = dict(vocab_size=29, num_layers=1, hidden_size=16, num_heads=2, num_kv_heads=2,
                intermediate_size=32, eos_token_id=11)
# heads of 128 (Qwen2-1.5B's width per head, its 6:1 grouping halved)
QWEN2_D128 = dict(vocab_size=211, hidden_size=768, intermediate_size=256, num_layers=2,
                  num_heads=6, num_kv_heads=1, rope_theta=1000000.0, norm_eps=1e-6,
                  attention_bias=True, tie_embeddings=False, eos_token_id=5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(kind: dict, seed: int, layout: str = "split"):
    """(JAX config, JAX params, port config, port params) from one init."""
    jcfg = jdec.DecoderConfig(**kind)
    jp = jdec.random_decoder_params(jcfg, seed=seed)
    if layout == "int8_fused":
        jp = jdec.fuse_decoder_params(jdec.quantize_decoder_params(jp))
    return jcfg, jp, tdec.DecoderConfig(**kind), tdec.decoder_params_from_numpy(_np(jp), device="cpu")


def _prompt(seed, b, s, vocab, pads=()):
    ids = np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)
    am = np.ones((b, s), np.int32)
    for row, pad in enumerate(pads):
        ids[row, :pad] = 0
        am[row, :pad] = 0
    return ids, am


def _trim(row, eos):
    row = list(row)
    return row[:row.index(eos)] if eos in row else row


# ------------------------------------------------------------------- K9

K9_HEADS = {"group1": (2, 2, 8), "group7": (14, 2, 8), "group4": (8, 2, 8), "group6": (12, 2, 8),
            "group1_d128": (2, 2, 128), "group4_d128": (8, 2, 128),
            "group6_d128": (12, 2, 128), "group7_d128": (14, 2, 128)}


@pytest.mark.parametrize("hq,hkv,d", list(K9_HEADS.values()), ids=list(K9_HEADS))
@pytest.mark.parametrize("pads", [(0, 100), (37, 255)])
def test_k9_plain_matches_pallas_and_attend(hq, hkv, d, pads):
    """B=2, S=256, head_dim 8 and 128 (the width of Qwen2-1.5B / -7B and
    Llama-3-8B, which the CUDA kernel serves with its own design), GQA
    groups 1, 4, 6 and 7, Pallas blocks of 128 (interpret mode). Real rows
    within 1e-5 of the Pallas kernel and of the decoder's masked attention;
    the port writes zeros in the padding rows."""
    b, s = 2, 256
    rng = np.random.default_rng(sum(pads) + hq)
    q = rng.standard_normal((b, s, hq * d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv * d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv * d)).astype(np.float32)
    pad = np.asarray(pads, np.int32)
    got = k9.causal_flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(pad),
                                  num_q_heads=hq, num_kv_heads=hkv).numpy()
    want = np.asarray(jax_causal_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pad), num_q_heads=hq, num_kv_heads=hkv,
                                       block_q=128, block_k=128, interpret=True))
    cfg = jdec.DecoderConfig(hidden_size=hq * d, num_heads=hq, num_kv_heads=hkv)
    pos = np.arange(s)
    mask = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] >= pad[:, None, None])
    attend = np.asarray(jdec._attend(jnp.asarray(q).reshape(b, s, hq, d),
                                     jnp.asarray(k).reshape(b, s, hkv, d),
                                     jnp.asarray(v).reshape(b, s, hkv, d),
                                     jnp.asarray(mask), cfg)).reshape(b, s, hq * d)
    for row in range(b):
        real = slice(pads[row], s)
        np.testing.assert_allclose(got[row, real], want[row, real], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[row, real], attend[row, real], atol=1e-5, rtol=0)
        assert (got[row, :pads[row]] == 0).all()


def test_k9_wrapper_counts_no_launch_on_the_cpu():
    x = torch.zeros(1, 64, 128)
    before = k9.LAUNCHES
    k9.causal_flash_prefill(x, x[..., :64].contiguous(), x[..., :64].contiguous(),
                            torch.zeros(1, dtype=torch.int32), num_q_heads=2, num_kv_heads=1)
    assert k9.LAUNCHES == before


# -------------------------------------------------------------- forward

@pytest.mark.parametrize("kind", ["qwen2", "llama"])
@pytest.mark.parametrize("padded", [False, True])
def test_decoder_forward_logits_match_jax(kind, padded):
    """Qwen2 shape: GQA, q/k/v biases, untied head. Llama shape: MHA, no
    biases, tied head. Left padding must not shift RoPE; padded positions'
    logits are not compared."""
    jcfg, jp, tcfg, tp = _pair(QWEN2 if kind == "qwen2" else LLAMA, seed=1)
    ids, am = _prompt(2, 2, 11, jcfg.vocab_size, pads=(4,) if padded else ())
    want = np.asarray(jdec.decoder_forward(jp, jnp.asarray(ids), jcfg, jnp.asarray(am)))
    got = tdec.decoder_forward(tp, ids, tcfg, am).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    real = am.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=1e-5, rtol=0)


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_matches_jax_prefill_and_cache(padded):
    """The prefill (attention through K9's plain version) against the JAX
    package's XLA prefill: last logits, and the cache on real slots."""
    jcfg, jp, tcfg, tp = _pair(QWEN2, seed=4)
    ids, am = _prompt(5, 2, 16, jcfg.vocab_size, pads=(0, 6) if padded else ())
    jl, jk, jv = jdec._prefill(jp, jnp.asarray(ids), jnp.asarray(am), 20, jcfg)
    tl, tk, tv = tdec._prefill(tp, torch.from_numpy(ids).long(), torch.from_numpy(am), 20, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    real = am.astype(bool)
    for got, want in ((tk, jk), (tv, jv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy()[:, :, :16][:, real],
                                   np.asarray(want)[:, :, :16][:, real], atol=1e-5, rtol=0)


# ------------------------------------------------------------ generation

GEN_CASES = [("qwen2", 2, (0, 3)), ("small", 1, ()), ("small", 1, (5,)), ("tiny_eos", 1, ()),
             ("qwen2_d128", 2, (0, 3))]
KINDS = {"qwen2": QWEN2, "llama": LLAMA, "small": SMALL, "tiny_eos": TINY_EOS,
         "qwen2_d128": QWEN2_D128}


def _gen_inputs(kind, b, pads, layout):
    jcfg, jp, tcfg, tp = _pair(KINDS[kind], seed=7, layout=layout)
    ids, am = _prompt(9, b, 12, jcfg.vocab_size, pads=pads)
    return jcfg, jp, tcfg, tp, ids, am


@pytest.mark.parametrize("layout", ["split", "int8_fused"])
@pytest.mark.parametrize("kind,b,pads", GEN_CASES)
def test_generate_tokens_and_stream_match_jax(layout, kind, b, pads):
    """Greedy tokens of generate_tokens and of the concatenated
    generate_stream blocks equal the JAX package's generate_tokens."""
    jcfg, jp, tcfg, tp, ids, am = _gen_inputs(kind, b, pads, layout)
    max_new = 16
    want = np.asarray(jdec.generate_tokens(jp, jnp.asarray(ids), jnp.asarray(am),
                                           jax.random.PRNGKey(0), cfg=jcfg,
                                           max_new_tokens=max_new))
    got = tdec.generate_tokens(tp, ids, am, cfg=tcfg, max_new_tokens=max_new)
    assert got.dtype == torch.int32 and got.shape == (b, max_new)
    np.testing.assert_array_equal(got.numpy(), want)
    for seg in (5, 16):
        blocks = list(tdec.generate_stream(tp, ids, am, cfg=tcfg, max_new_tokens=max_new,
                                           segment=seg))
        cat = np.concatenate(blocks, axis=1)
        for row in range(b):
            assert _trim(cat[row], tcfg.eos_token_id) == _trim(want[row], tcfg.eos_token_id)


@pytest.mark.parametrize("layout", ["split", "int8_fused"])
@pytest.mark.parametrize("kind,pads", [("small", ()), ("small", (5,)), ("qwen2", (3,)),
                                       ("tiny_eos", ())])
def test_speculative_generators_match_jax(layout, kind, pads):
    """generate_tokens_spec (tokens and verify-step count) and the
    concatenated generate_stream_spec blocks equal the JAX package's
    speculative output, and the greedy tokens, trimmed at eos."""
    jcfg, jp, tcfg, tp, ids, am = _gen_inputs(kind, 1, pads, layout)
    max_new, dk = 24, 4
    plain = np.asarray(jdec.generate_tokens(jp, jnp.asarray(ids), jnp.asarray(am),
                                            jax.random.PRNGKey(0), cfg=jcfg,
                                            max_new_tokens=max_new))[0]
    jspec, jsteps = jdec.generate_tokens_spec(jp, jnp.asarray(ids), jnp.asarray(am), cfg=jcfg,
                                              max_new_tokens=max_new, draft_k=dk)
    spec, steps = tdec.generate_tokens_spec(tp, ids, am, cfg=tcfg, max_new_tokens=max_new,
                                            draft_k=dk)
    np.testing.assert_array_equal(spec.numpy(), np.asarray(jspec))
    assert steps == int(jsteps)
    eos = tcfg.eos_token_id
    assert _trim(spec[0].tolist(), eos) == _trim(plain, eos)
    # segments of 5: the stream crosses several segment borders
    jstream = np.concatenate([b[0] for b in jdec.generate_stream_spec(
        jp, jnp.asarray(ids), jnp.asarray(am), cfg=jcfg, max_new_tokens=max_new,
        segment=5, draft_k=dk)])
    tstream = np.concatenate([b[0] for b in tdec.generate_stream_spec(
        tp, ids, am, cfg=tcfg, max_new_tokens=max_new, segment=5, draft_k=dk)])
    np.testing.assert_array_equal(tstream, jstream)
    assert _trim(tstream, eos) == _trim(plain, eos)


def test_pl_drafts_match_jax():
    rng = np.random.default_rng(3)
    ctx = rng.integers(0, 4, 40).astype(np.int32)
    for slot in (3, 17, 30, 39):
        for vf in (0, 5):
            want = np.asarray(jdec._pl_drafts(jnp.asarray(ctx), slot, vf, ngram=3, draft_k=7))
            got = tdec._pl_drafts(ctx.astype(np.int64), slot, vf, ngram=3, draft_k=7)
            np.testing.assert_array_equal(got, want)


def test_sampling_is_deterministic_in_the_seed():
    _, _, tcfg, tp = _pair(TINY_EOS | {"eos_token_id": 0, "vocab_size": 53}, seed=3)
    ids, am = np.asarray([[4, 9, 2]]), np.ones((1, 3), np.int32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tdec.generate_tokens(tp, ids, am, g, cfg=tcfg, max_new_tokens=8,
                                    temperature=0.8, top_k=10)

    assert torch.equal(run(9), run(9))
    g = torch.Generator().manual_seed(9)
    streamed = np.concatenate(list(tdec.generate_stream(
        tp, ids, am, g, cfg=tcfg, max_new_tokens=8, segment=4, temperature=0.8, top_k=10)), 1)
    np.testing.assert_array_equal(streamed, run(9).numpy())


# ------------------------------------------------------------------ params

def test_random_params_equal_jax():
    jcfg, jp, _, tp = _pair(QWEN2, seed=2)
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(), np.asarray(jp["lm_head"]))
    for name, stacked in jp["layers"].items():
        np.testing.assert_array_equal(np.stack([lp[name].numpy() for lp in tp["layers"]]),
                                      np.asarray(stacked), err_msg=name)


@pytest.mark.parametrize("kind", ["qwen2", "llama"])
def test_quantize_is_bit_identical_to_jax(kind):
    jcfg, jp, tcfg, tp = _pair(QWEN2 if kind == "qwen2" else LLAMA, seed=0)
    jq, tq = jdec.quantize_decoder_params(jp), tdec.quantize_decoder_params(tp)
    for part in ("q", "s"):
        np.testing.assert_array_equal(tq["lm_head"][part].numpy(), np.asarray(jq["lm_head"][part]))
        for name, leaf in jq["layers"].items():
            if isinstance(leaf, dict):
                got = np.stack([lp[name][part].numpy() for lp in tq["layers"]])
                np.testing.assert_array_equal(got, np.asarray(leaf[part]), err_msg=name)
    assert tq["layers"][0]["q_w"]["q"].dtype == torch.int8
    assert tq["embed"].dtype == torch.float32
    # the fused int8 layout from the JAX tree equals the port's own fusion
    tf = tdec.fuse_decoder_params(tq)
    jf = tdec.decoder_params_from_numpy(_np(jdec.fuse_decoder_params(jq)), device="cpu")
    for name in ("qkv_w", "gu_w"):
        assert torch.equal(tf["layers"][1][name]["q"], jf["layers"][1][name]["q"])
        assert torch.equal(tf["layers"][1][name]["s"], jf["layers"][1][name]["s"])


def test_state_dict_params_equal_jax():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Qwen2Config(
        vocab_size=211, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False, eos_token_id=5,
        architectures=["Qwen2ForCausalLM"])
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    with torch.no_grad():                 # HF initialises the q/k/v biases to zero
        for name, t in model.named_parameters():
            if name.endswith("proj.bias"):
                t.normal_(0.0, 0.02)
    sd = model.state_dict()
    jcfg = jdec.DecoderConfig.from_hf_config(hf_cfg.to_dict())
    tcfg = tdec.DecoderConfig.from_hf_config(hf_cfg.to_dict())
    assert tcfg == tdec.DecoderConfig(**QWEN2)
    assert tcfg.__dict__ == jcfg.__dict__
    jp = jdec.decoder_params_from_torch_state_dict(sd, jcfg)
    tp = tdec.decoder_params_from_torch_state_dict(sd, tcfg, device="cpu")
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(), np.asarray(jp["lm_head"]))
    for name, stacked in jp["layers"].items():
        np.testing.assert_array_equal(np.stack([lp[name].numpy() for lp in tp["layers"]]),
                                      np.asarray(stacked), err_msg=name)
    ids = np.random.default_rng(0).integers(1, 211, (2, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(tdec.decoder_forward(tp, ids, tcfg).numpy(), ref,
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("build", ["random", "numpy", "state_dict"])
def test_param_builders_place_weights_on_the_resolved_device(build, monkeypatch):
    """With no device the builders follow resolve_device: the card by
    default (so a machine without one raises), the CPU under
    FRAG_PLATFORM=cpu."""
    cfg = tdec.DecoderConfig(**TINY_EOS)
    tree = _np(jdec.random_decoder_params(jdec.DecoderConfig(**TINY_EOS), seed=0))
    sd = {"model.embed_tokens.weight": tree["embed"], "model.norm.weight": tree["final_ln"]}
    names = {"ln1": "input_layernorm", "q_w": "self_attn.q_proj", "k_w": "self_attn.k_proj",
             "v_w": "self_attn.v_proj", "o_w": "self_attn.o_proj",
             "ln2": "post_attention_layernorm", "gate_w": "mlp.gate_proj",
             "up_w": "mlp.up_proj", "down_w": "mlp.down_proj"}
    names.update(q_b="self_attn.q_proj", k_b="self_attn.k_proj", v_b="self_attn.v_proj")
    for i in range(cfg.num_layers):
        for k, a in tree["layers"].items():
            kind = "bias" if k.endswith("_b") else "weight"
            sd[f"model.layers.{i}.{names[k]}.{kind}"] = a[i].T if k.endswith("_w") else a[i]
    if "lm_head" in tree:
        sd["lm_head.weight"] = tree["lm_head"]
    builders = {"random": lambda: tdec.random_decoder_params(cfg, seed=0),
                "numpy": lambda: tdec.decoder_params_from_numpy(tree),
                "state_dict": lambda: tdec.decoder_params_from_torch_state_dict(sd, cfg)}
    monkeypatch.delenv("FRAG_PLATFORM", raising=False)
    if torch.cuda.is_available():
        assert builders[build]()["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            builders[build]()
    monkeypatch.setenv("FRAG_PLATFORM", "cpu")
    params = builders[build]()
    assert params["embed"].device.type == "cpu"
    assert params["layers"][0]["q_w"].device.type == "cpu"
