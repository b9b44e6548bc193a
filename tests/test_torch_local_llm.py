"""The port's on-device answer path against the JAX package on the CPU.

A tiny Qwen2 checkpoint directory, written as the JAX package's own tests
write one (``save_pretrained`` + a ``tokenizers`` WordLevel tokenizer +
a ChatML template), goes through both packages' LocalLLM: the same text
from generate, the joined stream, generate_many and the int8 layout. The
port's tokenizer.json reader is held to ``tokenizers`` itself, on this file
and on the one ``chip_smoke.py`` writes for the card.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from financial_rag_tpu.llm.local_llm import LocalLLM as JaxLocalLLM
from financial_rag_tpu_torch.config import FrameworkConfig, LLMConfig
from financial_rag_tpu_torch.llm import LocalLLM, get_provider
from financial_rag_tpu_torch.llm.provider import synthesize_answer
from financial_rag_tpu_torch.runtime import Runtime
from financial_rag_tpu_torch.tokenizer.hf_json import HFTokenizer

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent

TEXTS = [
    "w1 w2 w3 what is the rent",
    "Rs 40,000 (the Lessor); CGST: 9.5% -- done.",
    "café naïve résumé\nnew line\tand tab  <|im_start|>user\nw7<|im_end|>",
    "<|im_end|><|im_end|>w4",
    "x_y __init__ 3.14 ünïcödé …",
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """tests/test_decoder.py's tiny Qwen2 (biases, untied head, eos 5)."""
    d = tmp_path_factory.mktemp("tiny_llm")
    hf_cfg = transformers.Qwen2Config(
        vocab_size=211, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False, eos_token_id=5,
        attention_dropout=0.0)
    torch.manual_seed(0)
    transformers.Qwen2ForCausalLM(hf_cfg).eval().save_pretrained(str(d))
    vocab = {f"w{i}": i for i in range(200)}
    vocab.update({"<unk>": 200, "<|im_start|>": 201, "<|im_end|>": 202, "café": 203, ",": 204})
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.add_special_tokens(["<|im_end|>"])
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        '{"chat_template": "{% for m in messages %}<|im_start|>..."}')
    return d


@pytest.fixture(scope="module")
def llms(checkpoint_dir):
    return (JaxLocalLLM(model_dir=str(checkpoint_dir), dtype="float32"),
            LocalLLM(model_dir=str(checkpoint_dir), dtype="float32", device="cpu"))


# --------------------------------------------------------------- tokenizer

def _same_as_tokenizers(path):
    ref = tokenizers.Tokenizer.from_file(str(path))
    ours = HFTokenizer.from_file(path)
    for text in TEXTS:
        enc = ref.encode(text)
        assert ours.encode(text).ids == enc.ids, text
        assert ours.encode(text).tokens == enc.tokens, text
        ids = enc.ids + [10_000_000]          # an id outside the vocabulary is dropped
        for skip in (True, False):
            assert ours.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), (text, skip)


def test_reader_matches_tokenizers(checkpoint_dir):
    _same_as_tokenizers(checkpoint_dir / "tokenizer.json")


def test_reader_matches_tokenizers_on_the_chip_smoke_file(tmp_path):
    eos = _chip_smoke().write_wordlevel_tokenizer(tmp_path, ["rent", "lease", "café", "Rs"], 400)
    _same_as_tokenizers(tmp_path / "tokenizer.json")
    tok = HFTokenizer.from_file(tmp_path / "tokenizer.json")
    assert tok.id_to_token[eos] == "<|im_end|>" and len(tok.vocab) == 400


def test_reader_names_what_it_does_not_read(checkpoint_dir):
    spec = json.loads((checkpoint_dir / "tokenizer.json").read_text())
    # BPE, ByteLevel and NFC are read since the BPE reader (test_torch_hf_json.py)
    for key, value, needle in (("model", {"type": "Unigram"}, "Unigram"),
                               ("pre_tokenizer", {"type": "BertPreTokenizer"}, "BertPreTokenizer"),
                               ("decoder", {"type": "WordPiece"}, "WordPiece"),
                               ("normalizer", {"type": "NFKD"}, "NFKD")):
        with pytest.raises(NotImplementedError, match=needle):
            HFTokenizer(dict(spec, **{key: value}))


# --------------------------------------------------------------- LocalLLM

def test_generate_matches_jax(llms):
    jax_llm, llm = llms
    assert llm.available() and llm._chat == "chatml"
    for prompt, cap in (("w1 w2 w3 what is the rent", 16), ("w4 w5 w6", 8), ("café w9", 3)):
        want = jax_llm.generate(prompt, max_tokens=cap)
        assert llm.generate(prompt, max_tokens=cap) == want
        assert want is None or len(want.split()) <= cap


def test_stream_joins_to_generate_and_matches_jax(llms):
    jax_llm, llm = llms
    for segment in (5, 48):
        got = "".join(llm.generate_stream("w1 w2 w3", max_tokens=16, segment=segment))
        want = "".join(jax_llm.generate_stream("w1 w2 w3", max_tokens=16, segment=segment))
        assert got == want
        assert got.strip() == (llm.generate("w1 w2 w3", max_tokens=16) or "")


def test_generate_many_per_row_caps_match_jax(llms):
    jax_llm, llm = llms
    prompts = ["w1 w2 w3", "w9 w8 w7 w6 w5 w4 " * 30, "w100"]   # two prompt buckets
    got = llm.generate_many(prompts, max_tokens=[2, 12, 7])
    assert got == jax_llm.generate_many(prompts, max_tokens=[2, 12, 7])
    assert got == [llm.generate(p, max_tokens=m) for p, m in zip(prompts, [2, 12, 7])]
    assert llm.generate_many([]) == []


def test_int8_matches_jax(checkpoint_dir):
    jax_llm = JaxLocalLLM(model_dir=str(checkpoint_dir), dtype="int8")
    llm = LocalLLM(model_dir=str(checkpoint_dir), dtype="int8", device="cpu")
    assert llm.available()
    assert llm._params["layers"][0]["qkv_w"]["q"].dtype == torch.int8
    assert llm._params["embed"].dtype == torch.bfloat16
    for prompt in ("w3 w4 w5", "w1 w2 w3 what is the rent"):
        assert llm.generate(prompt, max_tokens=8) == jax_llm.generate(prompt, max_tokens=8)


def test_warm_runs_the_serving_path(llms):
    assert llms[1].warm() is True


def test_missing_checkpoint_degrades(tmp_path):
    llm = LocalLLM(model_dir=str(tmp_path / "nope"), device="cpu")
    assert not llm.available()
    assert llm.generate("q") is None and list(llm.generate_stream("q")) == []
    assert synthesize_answer(llm, "q", [{"content": "ctx"}]).startswith("LLM unavailable")


def test_local_llm_needs_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("FRAG_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalLLM(model_dir=str(tmp_path))


def test_get_provider_selects_the_ports_local_llm(checkpoint_dir, monkeypatch):
    monkeypatch.setenv("LLM_PROVIDER", "local")
    monkeypatch.setenv("LLM_CHECKPOINT", str(checkpoint_dir))
    provider = get_provider(LLMConfig(), device="cpu")
    assert isinstance(provider, LocalLLM) and provider.device == torch.device("cpu")
    assert provider.available()


def test_runtime_answers_with_the_local_llm(checkpoint_dir, tmp_path):
    """Runtime.build(device="cpu") with LLM_PROVIDER=local: the query
    normaliser and the answer both come from the decoder, on the plain and
    on the streaming path."""
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = cfg.encoders.gte_path = cfg.rerank.model_path = None
    cfg.serving.microbatch = False
    cfg.llm.provider = "local"
    cfg.llm.local_checkpoint = str(checkpoint_dir)
    cfg.llm.local_dtype = "float32"
    cfg.llm.local_max_new_tokens = 16
    rt = Runtime.build(cfg, data_dir=tmp_path / "data", device="cpu")
    assert isinstance(rt.engine.llm, LocalLLM) and rt.engine.llm.device == torch.device("cpu")
    src = tmp_path / "doc.json"
    src.write_text(json.dumps({"blocks": [{"content": "w1 w2 the rent is w9 w10 " * 20,
                                           "page": 0}]}))
    out = rt.pipeline.ingest_extracted_json(src, "doc", source_path=str(src), source_mtime=0.0)
    assert "error" not in out
    result = rt.engine.query("w1 w2 what is the rent")
    assert result["success"] and not rt.engine.llm._failed
    assert result["answer"] and not result["answer"].startswith("LLM unavailable")
    events = list(rt.engine.query_stream("w1 w2 what is the rent?"))
    deltas = "".join(d for kind, d in events if kind == "answer_delta")
    final = events[-1][1]
    assert events[-1][0] == "complete" and final["success"]
    assert deltas.strip() == final["answer"]
    assert not final["answer"].startswith("LLM unavailable")


# ------------------------------------------------ BPE tokenizer.json files

BPE = ROOT / "tests" / "data" / "bpe"


@pytest.fixture(scope="module")
def bpe_weights(tmp_path_factory):
    """A 2-layer Qwen2-shape checkpoint (hidden 64, untied head, so that
    greedy decoding does not just repeat the prompt's last token) as numpy
    weights written once: model.safetensors in f32, beside no tokenizer."""
    safetensors_numpy = pytest.importorskip("safetensors.numpy")

    d = tmp_path_factory.mktemp("bpe_weights")
    rng = np.random.default_rng(0)
    vocab, h, ff, kv = 3072, 64, 128, 32

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd = {"model.embed_tokens.weight": normal(vocab, h), "lm_head.weight": normal(vocab, h),
          "model.norm.weight": np.ones(h, np.float32)}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": np.ones(h, np.float32),
                   p + "post_attention_layernorm.weight": np.ones(h, np.float32),
                   p + "self_attn.q_proj.weight": normal(h, h), p + "self_attn.q_proj.bias": normal(h),
                   p + "self_attn.k_proj.weight": normal(kv, h), p + "self_attn.k_proj.bias": normal(kv),
                   p + "self_attn.v_proj.weight": normal(kv, h), p + "self_attn.v_proj.bias": normal(kv),
                   p + "self_attn.o_proj.weight": normal(h, h),
                   p + "mlp.gate_proj.weight": normal(ff, h), p + "mlp.up_proj.weight": normal(ff, h),
                   p + "mlp.down_proj.weight": normal(h, ff)})
    safetensors_numpy.save_file(sd, str(d / "model.safetensors"))
    hf = {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": vocab,
          "hidden_size": h, "intermediate_size": ff, "num_hidden_layers": 2,
          "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 4096,
          "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
          "hidden_act": "silu"}
    return d, hf


def _bpe_checkpoint(weights, root, family):
    """The weights with the family's committed tokenizer.json and template;
    eos (and bos) the family's end-of-turn token."""
    src, hf = weights
    d = root / family
    d.mkdir()
    (d / "model.safetensors").symlink_to(src / "model.safetensors")
    spec = json.loads((BPE / family / "tokenizer.json").read_text(encoding="utf-8"))
    eos = next(t["id"] for t in spec["added_tokens"]
               if t["content"] in ("<|im_end|>", "</s>"))
    (d / "config.json").write_text(json.dumps({**hf, "eos_token_id": eos, "bos_token_id": eos}))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (d / name).write_bytes((BPE / family / name).read_bytes())
    return d


BPE_PROMPTS = ["What is the rent for the second year?",
               "Rs 2,54,434 — café 日本 🙂 I'll check\r\nthe lease.",
               "[INST] nested [/INST] <|im_end|> text"]


@pytest.fixture(scope="module", params=["qwen2_style", "llama2_style"])
def bpe_llms(request, bpe_weights, tmp_path_factory):
    d = _bpe_checkpoint(bpe_weights, tmp_path_factory.mktemp("bpe_ckpt"), request.param)
    jax_llm = JaxLocalLLM(model_dir=str(d), dtype="float32")
    llm = LocalLLM(model_dir=str(d), dtype="float32", device="cpu")
    assert llm.available() and jax_llm.available() and not llm._failed
    return request.param, jax_llm, llm


def test_bpe_prompt_ids_match_jax(bpe_llms):
    family, jax_llm, llm = bpe_llms
    assert llm._chat == jax_llm._chat == {"qwen2_style": "chatml", "llama2_style": "inst"}[family]
    for prompt in BPE_PROMPTS:
        want_ids, want_mask = jax_llm._prep(prompt)
        ids, mask = llm._prep(prompt)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
        live = ids[0][mask[0] == 1].tolist()
        if family == "llama2_style":        # tokenizers' TemplateProcessing adds <s>
            assert live[0] == llm._tok.vocab["<s>"]
        else:
            assert live[0] == llm._tok.added["<|im_start|>"]


def test_bpe_greedy_tokens_and_answer_match_jax(bpe_llms):
    import jax
    import jax.numpy as jnp

    from financial_rag_tpu.models.decoder import generate_tokens as jax_generate
    from financial_rag_tpu_torch.models.decoder import generate_tokens

    _, jax_llm, llm = bpe_llms
    for prompt in BPE_PROMPTS:
        ids, mask = llm._prep(prompt)
        want = np.asarray(jax_generate(jax_llm._params, jnp.asarray(ids), jnp.asarray(mask),
                                       jax.random.PRNGKey(0), cfg=jax_llm._dcfg,
                                       max_new_tokens=24, temperature=0.0))
        got = generate_tokens(llm._params, ids, mask, cfg=llm._dcfg, max_new_tokens=24,
                              temperature=0.0)
        np.testing.assert_array_equal(np.asarray(got.cpu()), want)
        answer = llm.generate(prompt, max_tokens=24)
        assert answer == jax_llm.generate(prompt, max_tokens=24)
        assert answer and not answer.startswith("LLM unavailable")


def test_bpe_stream_matches_jax(bpe_llms):
    _, jax_llm, llm = bpe_llms
    for segment in (3, 48):
        got = "".join(llm.generate_stream(BPE_PROMPTS[1], max_tokens=20, segment=segment))
        want = "".join(jax_llm.generate_stream(BPE_PROMPTS[1], max_tokens=20, segment=segment))
        assert got == want
        assert got.strip() == (llm.generate(BPE_PROMPTS[1], max_tokens=20) or "")


def test_wordlevel_control_still_loads_in_both(bpe_weights, tmp_path):
    """The same weights with a WordLevel tokenizer.json (the file chip_smoke
    writes for the llm phases) load and answer alike in both packages."""
    d = tmp_path / "wordlevel"
    d.mkdir()
    (d / "model.safetensors").symlink_to(bpe_weights[0] / "model.safetensors")
    eos = _chip_smoke().write_wordlevel_tokenizer(d, ["rent", "lease", "year", "what", "is"],
                                                  bpe_weights[1]["vocab_size"])
    (d / "config.json").write_text(json.dumps({**bpe_weights[1], "eos_token_id": eos}))
    jax_llm = JaxLocalLLM(model_dir=str(d), dtype="float32")
    llm = LocalLLM(model_dir=str(d), dtype="float32", device="cpu")
    assert llm.available() and jax_llm.available()
    assert llm.generate("what is the rent", max_tokens=12) == \
        jax_llm.generate("what is the rent", max_tokens=12)


def test_chip_smoke_pads_the_bpe_fixture_without_changing_its_ids(tmp_path):
    """write_bpe_tokenizer: the fixture's vocabulary padded to the model's
    ids by tokens no merge reaches; the probes keep tokenizers' ids and
    every id decodes."""
    cs = _chip_smoke()
    eos = cs.write_bpe_tokenizer(tmp_path, BPE / "qwen2_style", 4096)
    tok = HFTokenizer.from_file(tmp_path / "tokenizer.json")
    assert tok.id_to_token[eos] == "<|im_end|>" and sorted(tok.id_to_token) == list(range(4096))
    assert cs.check_probes(tok, BPE / "qwen2_style") == len(json.loads(
        (BPE / "qwen2_style" / "probes.json").read_text(encoding="utf-8")))
    assert tok.decode([3500, 4000]) == " w3500 w4000"
    ref = tokenizers.Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    assert ref.decode([3500, 17, 4000]) == tok.decode([3500, 17, 4000])
