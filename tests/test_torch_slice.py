"""The port's served path end to end against the JAX package's.

Both ``Runtime.build``s get the same small checkpoint directories and ingest
the same Marker-JSON corpus; every golden question must come back with the
same child texts in the same order and the same answer. Texts, not ids, are
compared: child ids are clock-based snowflakes.
"""

import json

import numpy as np
import pytest
import torch

from financial_rag_tpu.config import FrameworkConfig as JaxFrameworkConfig
from financial_rag_tpu.config import ModelConfig as JaxModelConfig
from financial_rag_tpu.models import checkpoint as jckpt
from financial_rag_tpu.runtime import Runtime as JaxRuntime
from financial_rag_tpu_torch.config import FrameworkConfig
from financial_rag_tpu_torch.models.encoder import Encoder
from financial_rag_tpu_torch.runtime import Runtime, check_supported

torch.set_num_threads(2)

CORPUS = {
    "lease_2022": (
        "LEASE DEED executed between M/s Bhartiya Enterprises (the Lessor) and "
        "Acme Trading Pvt Ltd (the Lessee). The monthly rent for the first year "
        "shall be Rs 40,000. The monthly rent for the second year shall be "
        "Rs 42,800. The lock-in period under this lease is 36 months from the "
        "commencement date of 1 April 2022. A security deposit of Rs 2,40,000 "
        "is payable on signing. " * 2
    ),
    "invoice_cn24": (
        "TAX INVOICE / CREDIT NOTE No. CN/24 dated 30-Jul-22 issued by Bhartiya "
        "Enterprises, Chakulia. Taxable value Rs 2,15,625. CGST at 9 percent: "
        "Rs 19,406.25. SGST at 9 percent: Rs 19,406.25. Total invoice amount "
        "Rs 2,54,434 rounded. GSTIN 20AAIPL4886F1ZQ. " * 2
    ),
    "salary_memo": (
        "INTERNAL MEMO: the annual appraisal cycle concludes in March. Salary "
        "revisions take effect from 1 April. The travel reimbursement cap is "
        "Rs 3,500 per trip for domestic travel and requires manager approval. " * 3
    ),
    "insurance_policy": (
        "FIRE INSURANCE POLICY No. FI-9981 covering the warehouse at Chakulia. "
        "The sum insured is Rs 75,00,000. The annual premium is Rs 82,500 "
        "payable before 15 June each year. The policy excludes flood damage. " * 2
    ),
    "utility_bills": (
        "ELECTRICITY STATEMENT for March: units consumed 12,480, amount payable "
        "Rs 1,12,320 by the due date of 21 April. Late payment surcharge is 1.5 "
        "percent per month. Meter number JH-40213. " * 3
    ),
}

GOLDEN = [
    "What is the rent for the second year?",
    "What is the lock-in period of the lease?",
    "Who is the lessor?",
    "What is the total invoice amount on the credit note?",
    "What is the CGST amount?",
    "What is the sum insured under the fire policy?",
    "What is the annual premium for the insurance?",
    "What is the travel reimbursement cap per trip?",
    "How many electricity units were consumed in March?",
]

SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             vocab_size=30522, max_position=512)


def _write_checkpoint(d, seed, classifier=False):
    d.mkdir(parents=True)
    cfg = JaxModelConfig(**SMALL, num_labels=1 if classifier else 0)
    raw = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
           "intermediate_size": 128, "vocab_size": 30522, "max_position_embeddings": 512,
           "type_vocab_size": 2, "layer_norm_eps": 1e-12}
    if classifier:
        raw.update(architectures=["BertForSequenceClassification"], id2label={"0": "LABEL_0"})
    (d / "config.json").write_text(json.dumps(raw))
    jckpt.save_params_npz(jckpt.random_params(cfg, seed=seed), d / "model.npz")


def _config(cls, ckpt):
    cfg = cls()
    cfg.encoders.baai_path = str(ckpt / "bge")
    cfg.encoders.gte_path = str(ckpt / "gte")
    cfg.rerank.model_path = str(ckpt / "ce")
    cfg.serving.microbatch = False
    cfg.llm.provider = "gemini"
    cfg.llm.gemini_api_key = None
    return cfg


def _ingest(rt, src):
    for doc_id in CORPUS:
        f = src / f"{doc_id}.json"
        out = rt.pipeline.ingest_extracted_json(f, doc_id, source_path=str(f),
                                                source_mtime=0.0)
        assert "error" not in out and out["children"] > 0


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    mp = pytest.MonkeyPatch()
    mp.delenv("FRAG_PLATFORM", raising=False)
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
    ckpt = tmp / "ckpt"
    _write_checkpoint(ckpt / "bge", seed=1)
    _write_checkpoint(ckpt / "gte", seed=2)
    _write_checkpoint(ckpt / "ce", seed=3, classifier=True)
    src = tmp / "src"
    src.mkdir()
    for doc_id, text in CORPUS.items():
        (src / f"{doc_id}.json").write_text(json.dumps({"blocks": [{"content": text, "page": 0}]}))
    jrt = JaxRuntime.build(_config(JaxFrameworkConfig, ckpt), data_dir=tmp / "jax")
    trt = Runtime.build(_config(FrameworkConfig, ckpt), data_dir=tmp / "port", device="cpu")
    _ingest(jrt, src)
    _ingest(trt, src)
    jrt.ingest_root, trt.ingest_root = tmp / "jax", tmp / "port"
    yield jrt, trt
    mp.undo()


def test_port_runtime_loads_real_encoders_and_reranker(runtimes):
    _, trt = runtimes
    assert all(isinstance(e, Encoder) for e in trt.dual_encoder.encoders.values())
    assert trt.engine.reranker.model is not None
    assert trt.device == torch.device("cpu")
    assert {i.backend for i in trt.indexes.values()} == {"xla"}


@pytest.mark.parametrize("question", GOLDEN)
def test_same_children_and_answer_as_jax(runtimes, question):
    jrt, trt = runtimes
    jout = jrt.engine.query(question)
    tout = trt.engine.query(question)
    assert jout["success"] and tout["success"]
    jtexts = [c["text"] for c in jout["top_children_chunks"]]
    ttexts = [c["text"] for c in tout["top_children_chunks"]]
    assert ttexts and ttexts == jtexts
    assert tout["answer"] == jout["answer"]
    assert tout["query_strategy"] == jout["query_strategy"]
    # rerank scores where the strategy reranks ("Aggregation" keeps the order)
    jscores = [c.get("final_rerank_score") for c in jout["top_children_chunks"]]
    tscores = [c.get("final_rerank_score") for c in tout["top_children_chunks"]]
    assert [s is None for s in tscores] == [s is None for s in jscores]
    if jscores[0] is not None:
        np.testing.assert_allclose(tscores, jscores, atol=1e-3)


def test_build_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.delenv("FRAG_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Runtime.build(FrameworkConfig(), data_dir=tmp_path / "d")
    assert not (tmp_path / "d").exists()


def test_frag_platform_cpu_selects_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAG_PLATFORM", "cpu")
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = cfg.encoders.gte_path = cfg.rerank.model_path = None
    rt = Runtime.build(cfg, data_dir=tmp_path)
    assert rt.device == torch.device("cpu")


@pytest.mark.parametrize("field,value", [("mesh.index_shards", 4), ("mesh.encode_dp", 2)])
def test_sharded_and_data_parallel_configurations_are_served_on_cuda(field, value):
    cfg = FrameworkConfig()
    group, name = field.split(".")
    setattr(getattr(cfg, group), name, value)
    check_supported(cfg, torch.device("cuda"))


@pytest.mark.parametrize("hidden,heads,inter,refused", [
    (768, 12, 3072, None),                 # bge-base: K7 takes D 768
    (1024, 16, 4096, None),                # bge-large: K3 at 1,024, K7 takes D 1,024
    (2048, 32, 8192, "K7"),                # head_dim 64, K3's generic route, D above 1,024
    (2048, 16, 8192, "K2"),                # heads of 128
])
def test_sharded_configurations_keep_refusing_the_widths(tmp_path, hidden, heads, inter,
                                                         refused):
    """INDEX_SHARDS and ENCODE_DP leave the width check as it was: the
    sharded flat index sweeps through K7 (D <= 1,024), and the encoders still
    run K2 and K3 on every replica."""
    d = tmp_path / "enc"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "hidden_size": hidden, "num_hidden_layers": 2, "num_attention_heads": heads,
        "intermediate_size": inter, "vocab_size": 30522, "max_position_embeddings": 512}))
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = str(d)
    cfg.encoders.gte_path = cfg.rerank.model_path = None
    cfg.mesh.index_shards, cfg.mesh.encode_dp = 4, 2
    check_supported(cfg, torch.device("cpu"))
    if refused is None:
        check_supported(cfg, torch.device("cuda"))
        return
    with pytest.raises(NotImplementedError, match=rf"baai: .*{refused}") as err:
        check_supported(cfg, torch.device("cuda"))
    assert "flat sweeps (K7) take D <= 1024" in str(err.value)


def test_local_llm_configuration_is_served_on_cuda():
    cfg = FrameworkConfig()
    cfg.llm.provider = "local"
    cfg.llm.local_checkpoint = "/nonexistent"
    check_supported(cfg, torch.device("cuda"))


@pytest.mark.parametrize("hidden,heads,kv_heads,refused", [
    (896, 14, 2, False),     # Qwen2-0.5B: head_dim 64
    (1536, 12, 2, False),    # Qwen2-1.5B: head_dim 128
    (4096, 32, 8, False),    # Llama-3-8B: head_dim 128
    (1280, 16, 4, False),    # head_dim 80: zero-padded to 128
    (1536, 16, 4, False),    # head_dim 96: likewise
    (3200, 32, 32, False),   # open_llama_3b_v2: head_dim 100
    (2560, 16, 4, True),     # head_dim 160
])
def test_check_supported_reads_the_local_llm_head_dim(tmp_path, hidden, heads, kv_heads, refused):
    """With LLM_PROVIDER=local, check_supported on CUDA reads the decoder
    checkpoint's config.json and refuses a head_dim that K9 does not take
    (above 128), naming K9, at build: the first prefill would raise inside
    the provider, which degrades every answer to the no-LLM text. Heads of
    80, 96 and 100 are zero-padded to 128. The CPU takes every width."""
    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["Qwen2ForCausalLM"], "vocab_size": 1024, "num_hidden_layers": 2,
        "hidden_size": hidden, "num_attention_heads": heads, "num_key_value_heads": kv_heads,
        "intermediate_size": 4 * hidden}))
    cfg = FrameworkConfig()
    cfg.llm.provider, cfg.llm.local_checkpoint = "local", str(tmp_path)
    check_supported(cfg, torch.device("cpu"))
    if not refused:
        check_supported(cfg, torch.device("cuda"))
        return
    with pytest.raises(NotImplementedError, match=r"local LLM: head_dim \d+, but "
                       r"causal_flash_prefill \(K9\) takes head_dim <= 128"):
        check_supported(cfg, torch.device("cuda"))
    cfg.llm.provider = "gemini"          # the checkpoint is read only for a local LLM
    check_supported(cfg, torch.device("cuda"))


def test_int8_index_is_served_on_the_cpu():
    cfg = FrameworkConfig()
    cfg.index.dtype = "int8"
    check_supported(cfg, torch.device("cpu"))


@pytest.mark.parametrize("field,value", [("index.dtype", "int8"), ("index.kind", "ivf")])
def test_int8_and_ivf_configurations_are_served_on_cuda(field, value):
    cfg = FrameworkConfig()
    group, name = field.split(".")
    setattr(getattr(cfg, group), name, value)
    check_supported(cfg, torch.device("cuda"))


def test_int8_runtime_reloads_the_bf16_indexes_and_answers_as_jax(runtimes, tmp_path):
    """The restart path: both packages' bf16 indexes are saved, and each
    package's runtime built on its data dir with INDEX_DTYPE=int8 reloads and
    re-quantizes them; the port (int8 exact sweep on the CPU) returns the
    JAX package's child texts. The feedback DB stays behind: its result cache
    would answer the questions without a search."""
    import shutil

    jrt, trt = runtimes
    dirs = {}
    for tag, rt in (("jax", jrt), ("port", trt)):
        src = rt.ingest_root
        rt.save_indexes(src)
        dirs[tag] = tmp_path / tag
        shutil.copytree(src, dirs[tag], ignore=shutil.ignore_patterns("jax_cache", "feedback.db*"))
    ckpt = jrt.ingest_root.parent / "ckpt"
    jcfg, tcfg = _config(JaxFrameworkConfig, ckpt), _config(FrameworkConfig, ckpt)
    jcfg.index.dtype = tcfg.index.dtype = "int8"
    j8 = JaxRuntime.build(jcfg, data_dir=dirs["jax"])
    t8 = Runtime.build(tcfg, data_dir=dirs["port"], device="cpu")
    assert all(i.dtype == torch.int8 for i in t8.indexes.values())
    for question in GOLDEN[:4]:
        jout, tout = j8.engine.query(question), t8.engine.query(question)
        assert not jout.get("cache_hit") and not tout.get("cache_hit")
        jtexts = [c["text"] for c in jout["top_children_chunks"]]
        ttexts = [c["text"] for c in tout["top_children_chunks"]]
        assert ttexts and ttexts == jtexts, question


def _write_wide_checkpoint(d, seed):
    """A seeded bge-base-shaped BERT (hidden 768, 12 heads of 64), one layer."""
    d.mkdir(parents=True)
    cfg = JaxModelConfig(hidden_size=768, num_layers=1, num_heads=12, intermediate_size=3072,
                         vocab_size=30522, max_position=512)
    (d / "config.json").write_text(json.dumps({
        "hidden_size": 768, "num_hidden_layers": 1, "num_attention_heads": 12,
        "intermediate_size": 3072, "vocab_size": 30522, "max_position_embeddings": 512,
        "type_vocab_size": 2, "layer_norm_eps": 1e-12}))
    jckpt.save_params_npz(jckpt.random_params(cfg, seed=seed), d / "model.npz")


@pytest.fixture(scope="module")
def wide_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("wide") / "bge-base"
    _write_wide_checkpoint(d, seed=7)
    return d


def test_cuda_runtime_refuses_widths_the_kernels_do_not_take(wide_checkpoint, tmp_path,
                                                              monkeypatch):
    """On CUDA the bge-base width (768 = 12 heads of 64, FFN 3,072, D 768)
    passes the kernels' width check, and Runtime.build refuses an encoder
    wider than bge-large with heads of 128 (hidden 2,048) before it loads
    a weight or creates the data dir, naming K2's and the flat sweeps'
    limits (K3's generic route takes hidden 2,048); the CPU serves the
    768-wide checkpoint."""
    import financial_rag_tpu_torch.runtime as runtime_mod

    cfg = FrameworkConfig()
    cfg.encoders.baai_path = str(wide_checkpoint)
    cfg.encoders.gte_path = cfg.rerank.model_path = None
    check_supported(cfg, torch.device("cuda"))

    large = tmp_path / "large"
    large.mkdir()
    (large / "config.json").write_text(json.dumps({
        "hidden_size": 2048, "num_hidden_layers": 24, "num_attention_heads": 16,
        "intermediate_size": 8192, "vocab_size": 30522, "max_position_embeddings": 512}))
    wide_cfg = FrameworkConfig()
    wide_cfg.encoders.baai_path = str(large)
    wide_cfg.encoders.gte_path = wide_cfg.rerank.model_path = None
    monkeypatch.setattr(runtime_mod, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(NotImplementedError) as err:
        Runtime.build(wide_cfg, data_dir=tmp_path / "cuda")
    msg = str(err.value)
    assert "baai: head_dim 128, but flash_attention (K2) takes head_dim <= 64" in msg
    assert "(K3)" not in msg   # 2,048 / 8,192 takes K3's generic route
    assert "flat sweeps (K4-K7) take D <= 1024" in msg
    assert not (tmp_path / "cuda").exists()
    monkeypatch.undo()

    rt = Runtime.build(cfg, data_dir=tmp_path / "cpu", device="cpu")
    assert rt.dual_encoder.encoders["baai"].dim == 768
    vec = rt.dual_encoder.encode_all(["what is the rent"])["baai"]
    assert vec.shape == (1, 768) and np.isfinite(vec).all()


@pytest.mark.parametrize("hidden,heads,inter,kind,refused", [
    (384, 12, 1536, "flat", None),                   # bge-small / gte-small / MiniLM
    (768, 12, 3072, "flat", None),                   # bge-base / gte-base: head_dim 64
    (768, 24, 3072, "ivf", None),                    # head_dim 32 at hidden 768
    (384, 12, 1000, "flat", None),                   # K3's generic route: I not whole chunks
    (768, 12, 3000, "flat", None),                   # and at 768
    (768, 12, 3040, "flat", None),                   # a multiple of 16, not of 64
    (1024, 16, 4096, "flat", None),                  # bge-large / gte-large: head_dim 64
    (512, 16, 2048, "flat", None),                   # hidden 512 (BERT-Small)
    (2048, 32, 8192, "ivf", None),                   # and 2,048 (K8 takes the rows)
    (312, 12, 1200, "flat", None),                   # TinyBERT-L-4: heads of 26
    (128, 2, 512, "flat", None),                     # TinyBERT-L-2-v2
    (1024, 8, 4096, "ivf", "K2"),                    # head_dim 128
    (960, 12, 3840, "flat", "K2"),                   # head_dim 80
    (100, 4, 400, "flat", "K3"),                     # hidden 100: rows not whole 16-byte chunks
    (768, 12, 3004, "flat", "K3"),                   # nor I 3,004
])
def test_check_supported_reads_the_checkpoint_widths(tmp_path, hidden, heads, inter, kind,
                                                     refused):
    """check_supported on CUDA reads each checkpoint's config.json (the
    reranker's too); the CPU takes every width."""
    d = tmp_path / "ce"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "hidden_size": hidden, "num_hidden_layers": 6, "num_attention_heads": heads,
        "intermediate_size": inter, "vocab_size": 30522, "max_position_embeddings": 512}))
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = cfg.encoders.gte_path = None
    cfg.rerank.model_path = str(d)
    cfg.index.kind = kind
    check_supported(cfg, torch.device("cpu"))
    if refused is None:
        check_supported(cfg, torch.device("cuda"))
    else:
        with pytest.raises(NotImplementedError, match=rf"reranker: .*{refused}"):
            check_supported(cfg, torch.device("cuda"))
