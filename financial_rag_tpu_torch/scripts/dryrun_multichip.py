"""One step of each multi-device path: training, sharded search, data-parallel
encode, sharded IVF, tensor-parallel decoding and the sharded engine.

    python -m financial_rag_tpu_torch.scripts.dryrun_multichip [--world 4] [--device cpu|cuda]

Counterpart of the JAX package's ``dryrun_multichip`` (__graft_entry__.py).
Section 1 is the contrastive train step on
``make_mesh([("data", -1), ("model", 2)])`` (tp 1 where the world size is
odd) at the dryrun's tiny config (2 layers, hidden 128, 4 heads of 32, FFN
256, vocab 512), batch 4 x dp pairs of 32 tokens, one step. With tp 2 the
step must resolve ``pallas_tp`` (K11 on the local heads) and every rank's
loss must be finite and equal. Each rank is a process (parallel/launch.py):
on the GPU they share the cards over gloo where there are fewer cards than
ranks, and take one each over NCCL otherwise.

Section 5 is the tensor-parallel decoder on section 1's mesh, one process a
rank: the JAX dryrun's tiny decoder (vocab 256, 2 layers, 4 query / 2 kv
heads, FFN 128, attention bias, eos 0, f32; hidden 64 on the CPU and 256 on
the GPU, where K9 takes heads of 64 or 128 only), ``shard_decoder_params``
and ``shard_decoder_inputs``, dp rows of 8 prompt tokens, 4 new greedy
tokens: every rank's tokens must equal the single-rank port's.

Sections 2-4 and 6 run in this process over ``--world`` devices
(``parallel.mesh.search_devices``; on one GPU every shard sits on it):

2. ``ShardedFlatIndex`` over them: 64 vectors of 128, self-retrieval;
3. data-parallel encode, one replica a device, against one device;
4. an int8 ``ShardedIVFIndex``, one partition a device: self-retrieval;
6. two complete ``Runtime``s on seeded random checkpoints (2-layer encoders
   and cross-encoder at hidden 384, a 2-layer Qwen2-style decoder at f32):
   one with the indexes sharded and the encode data-parallel over every
   device, one on a single device, ingest the same lease document and must
   give the same retrieved child texts, in the same order, and the same
   answers for the golden questions, one of them streamed through the
   continuous-batching decode.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from financial_rag_tpu_torch.config import FrameworkConfig, ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.checkpoint import random_params, save_params_npz
from financial_rag_tpu_torch.models.decoder import (DecoderConfig, generate_tokens,
                                                    random_decoder_params, shard_decoder_inputs,
                                                    shard_decoder_params)
from financial_rag_tpu_torch.parallel import (ShardedFlatIndex, ShardedIVFIndex, launch,
                                              make_mesh, search_devices)
from financial_rag_tpu_torch.training.contrastive import make_train_step

# The timeout of every collective (the default group's and the mesh's)
TIMEOUT_S = 120
DRYRUN_CONFIG = dict(name="tiny-dryrun", hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512, max_position=64)


def train_rank(rank: int, world: int, device: torch.device) -> dict:
    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh([("data", -1), ("model", tp)], timeout_s=TIMEOUT_S)
    dp = mesh.shape["data"]
    config = ModelConfig(**DRYRUN_CONFIG)
    step, init_state = make_train_step(config, mesh, device=device)
    if tp > 1:
        assert step.attention_impl == "pallas_tp", step.attention_impl
    params, opt_state = init_state(random_params(config, seed=0))
    rng = np.random.default_rng(0)
    b, s = 4 * dp, 32
    batch = {"q_ids": rng.integers(1, 512, (b, s)).astype(np.int32),
             "q_mask": np.ones((b, s), np.int32),
             "d_ids": rng.integers(1, 512, (b, s)).astype(np.int32),
             "d_mask": np.ones((b, s), np.int32)}
    params, opt_state, loss = step(params, opt_state, batch)
    loss = float(loss)
    assert math.isfinite(loss), f"training step produced non-finite loss {loss}"
    return {"loss": loss, "mesh": dict(mesh.shape), "attention_impl": step.attention_impl,
            "device": str(device)}


def sharded_search(n: int, device: torch.device) -> int:
    """Section 2: the corpus over n shards, self-retrieval."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((64, 128)).astype(np.float32)
    idx = ShardedFlatIndex(search_devices(n, device), dim=128, capacity_per_shard=1024)
    idx.upsert(np.arange(1, 65, dtype=np.int64), vecs)
    ids, _ = idx.search(vecs[:4], top_k=5)
    assert ids.shape == (4, 5)
    assert (ids[:, 0] == np.arange(1, 5)).all(), "sharded search failed self-retrieval"
    return idx.n_shards


def dp_encode(n: int, device: torch.device) -> float:
    """Section 3: one replica a device against one device; returns the
    largest difference."""
    from financial_rag_tpu_torch.models.encoder import Encoder

    cfg = ModelConfig(name="tiny-dp", hidden_size=64, num_layers=2, num_heads=4,
                      intermediate_size=128, vocab_size=30522, max_position=128)
    params = random_params(cfg, seed=0)
    texts = [f"dp encode text {i}" for i in range(n * 2)]
    kw = dict(pooling="mean", batch_size=8, max_seq_len=64, device=device)
    emb = Encoder(cfg, params, replicas=search_devices(n, device), **kw).encode(texts)
    assert emb.shape == (n * 2, 64)
    return float(np.abs(emb - Encoder(cfg, params, **kw).encode(texts)).max())


def sharded_ivf(n: int, device: torch.device) -> int:
    """Section 4: an int8 IVF partition a device, self-retrieval."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((64, 128)).astype(np.float32)
    ivf = ShardedIVFIndex(search_devices(n, device), dim=128, nlist=4, list_size=128,
                          nprobe=4, dtype=torch.int8)
    ivf.upsert(np.arange(1, 65, dtype=np.int64), vecs)
    ids, _ = ivf.search(vecs[:4], top_k=5)
    assert (ids[:, 0] == np.arange(1, 5)).all(), "sharded IVF failed self-retrieval"
    return ivf.n_shards


# ---------------------------------------- section 5: the decoder under TP

DECODER_TP = dict(vocab_size=256, num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2,
                  intermediate_size=128, attention_bias=True, eos_token_id=0)
DECODER_NEW_TOKENS = 4


def decoder_config(device: torch.device) -> DecoderConfig:
    """The JAX dryrun's decoder; on the GPU at heads of 64 (hidden 256), the
    narrowest width K9 is built for."""
    fields = dict(DECODER_TP)
    if device.type == "cuda":
        fields["hidden_size"] = 64 * fields["num_heads"]
    return DecoderConfig(**fields)


def decoder_prompt(dp: int):
    ids = np.random.default_rng(0).integers(1, DECODER_TP["vocab_size"], (dp, 8))
    return ids.astype(np.int32), np.ones((dp, 8), np.int32)


def decoder_rank(rank: int, world: int, device: torch.device) -> dict:
    """Section 5 on one rank: greedy tokens of its shard_decoder_params
    slice, gathered over the data axis."""
    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh([("data", -1), ("model", tp)], timeout_s=TIMEOUT_S)
    cfg = decoder_config(device)
    params = shard_decoder_params(random_decoder_params(cfg, seed=0, device=device), mesh, cfg)
    ids, mask = decoder_prompt(mesh.shape["data"])
    toks = generate_tokens(params, *shard_decoder_inputs(ids, mask, mesh), cfg=cfg,
                           max_new_tokens=DECODER_NEW_TOKENS)
    return {"mesh": dict(mesh.shape), "tokens": toks.cpu().numpy()}


def decoder_tp(world: int, device: torch.device) -> dict:
    """Section 5: ``world`` ranks against the single-rank port."""
    out = launch.spawn(decoder_rank, world, device=device, timeout_s=TIMEOUT_S)
    cfg = decoder_config(device)
    dp = out[0]["mesh"]["data"]
    ref = generate_tokens(random_decoder_params(cfg, seed=0, device=device), *decoder_prompt(dp),
                          cfg=cfg, max_new_tokens=DECODER_NEW_TOKENS).cpu().numpy()
    for r in out:
        if r["tokens"].shape != (dp, DECODER_NEW_TOKENS) or (r["tokens"] != ref).any():
            raise AssertionError(f"TP generation diverged from single-device: {r['tokens']} "
                                 f"against {ref}")
    return {"mesh": out[0]["mesh"], "hidden_size": cfg.hidden_size, "tokens": ref.tolist()}


# ------------------------------------------------- section 6: the engine

FACTS = [
    ("The rent for the first year is 40,000 rupees per month as agreed in the lease "
     "schedule.", 1),
    ("The rent for the second year increases to 42,800 rupees per month.", 1),
    ("The lock-in period of the lease is 36 months from the commencement date.", 2),
    ("The lessor is Bhartiya Enterprises, East Singhbhum district, Jharkhand.", 2),
    ("The invoice total amount payable is 118,000 rupees including GST of 18,000 rupees.", 3),
]
# each fact a block of its own, long enough to make children of its own
LEASE = {"blocks": [{"content": " ".join([text] * 8), "page": page} for text, page in FACTS]}
QUESTIONS = ["What is the rent for the first year?", "What is the lock-in period?",
             "Who is the lessor?"]
BERT = {"hidden_size": 384, "num_hidden_layers": 2, "num_attention_heads": 12,
        "intermediate_size": 1536, "vocab_size": 30522, "max_position_embeddings": 512,
        "type_vocab_size": 2, "layer_norm_eps": 1e-12}
DECODER = {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": 512,
           "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
           "num_attention_heads": 2, "num_key_value_heads": 1, "max_position_embeddings": 4096,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": True}
WORDS = ("the a is of for to in and what who rent year first second lock period lessor "
         "invoice amount gst total context question answer document page lease rupees month "
         "months from date agreed schedule increases commencement district enterprises "
         "payable including per as").split()


def write_engine_checkpoints(dest: Path) -> Path:
    """Seeded random checkpoints the runtime loads: two encoders and a
    cross-encoder (config.json + model.npz, the vendored vocabulary) and a
    Qwen2-style decoder (config.json, pytorch_model.bin and a WordLevel
    tokenizer.json over common words)."""
    for name, seed, labels in (("baai", 0, 0), ("gte", 1, 0), ("cross", 2, 1)):
        d = dest / name
        d.mkdir(parents=True, exist_ok=True)
        raw = dict(BERT)
        if labels:
            raw.update(architectures=["BertForSequenceClassification"], id2label={"0": "L"})
        (d / "config.json").write_text(json.dumps(raw))
        save_params_npz(random_params(ModelConfig.from_json(d), seed=seed), d / "model.npz")

    d = dest / "llm"
    d.mkdir(parents=True, exist_ok=True)
    vocab = {w: i for i, w in enumerate(WORDS)}
    vocab.update({f"w{i}": i for i in range(len(vocab), 496)})
    vocab.update({"<unk>": 496, "<|im_start|>": 497, "<|im_end|>": 498, "user": 499})
    (d / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
        "normalizer": None, "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None,
        "decoder": None, "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": "{% for m in messages %}{{ m['content'] }}{% endfor %}"}))
    (d / "config.json").write_text(json.dumps({**DECODER, "eos_token_id": 500,
                                               "bos_token_id": 500}))
    gen = torch.Generator().manual_seed(3)
    h, ff, v = DECODER["hidden_size"], DECODER["intermediate_size"], DECODER["vocab_size"]
    kv = h // DECODER["num_attention_heads"] * DECODER["num_key_value_heads"]

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.2

    sd = {"model.embed_tokens.weight": normal(v, h), "model.norm.weight": torch.ones(h)}
    for i in range(DECODER["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for proj, rows in (("q", h), ("k", kv), ("v", kv)):
            sd[p + f"self_attn.{proj}_proj.weight"] = normal(rows, h)
            sd[p + f"self_attn.{proj}_proj.bias"] = normal(rows)
        sd.update({p + "self_attn.o_proj.weight": normal(h, h),
                   p + "input_layernorm.weight": torch.ones(h),
                   p + "post_attention_layernorm.weight": torch.ones(h),
                   p + "mlp.gate_proj.weight": normal(ff, h),
                   p + "mlp.up_proj.weight": normal(ff, h),
                   p + "mlp.down_proj.weight": normal(h, ff)})
    torch.save(sd, d / "pytorch_model.bin")
    return dest


def engine_config(cfg, ckpt: Path, shards: int, encode_dp: int):
    """Either package's FrameworkConfig set as section 6 builds it."""
    cfg.mesh.index_shards = shards
    cfg.mesh.encode_dp = encode_dp
    cfg.encoders.baai_path = str(ckpt / "baai")
    cfg.encoders.gte_path = str(ckpt / "gte")
    cfg.encoders.encode_batch_size = 16
    cfg.encoders.max_seq_len = 64
    cfg.rerank.model_path = str(ckpt / "cross")
    cfg.llm.provider = "local"
    cfg.llm.local_checkpoint = str(ckpt / "llm")
    cfg.llm.local_dtype = "float32"   # greedy decode: exact across layouts
    cfg.llm.local_max_new_tokens = 24
    cfg.llm.local_continuous_window = 64
    cfg.serving.microbatch = True
    cfg.serving.microbatch_direct = 1  # a 2nd concurrent stream joins the shared decode
    cfg.index.capacity = 1024
    return cfg


def engine_answers(rt) -> list:
    """(retrieved child texts, answer) of each golden question; texts, not
    ids: child ids are clock-based snowflakes."""
    out = []
    for q in QUESTIONS:
        r = rt.engine.query(q, topn=3)
        out.append(([c["text"] for c in r["top_children_chunks"]], r["answer"]))
    return out


def full_engine(n: int, device: torch.device, base: Path) -> dict:
    """Section 6 in ``base``: returns the report and the sharded runtime's
    answers."""
    from financial_rag_tpu_torch.runtime import Runtime

    ckpt = write_engine_checkpoints(base / "ckpt")
    doc = base / "lease.json"
    doc.write_text(json.dumps(LEASE))

    def build(tag: str, shards: int, encode_dp: int):
        cfg = engine_config(FrameworkConfig(), ckpt, shards, encode_dp)
        rt = Runtime.build(cfg, data_dir=base / tag, device=device)
        rt.pipeline.ingest_extracted_json(doc, f"lease-{tag}")
        return rt

    multi = build("multi", n, n)
    single = build("single", 0, 0)
    try:
        assert all(isinstance(ix, ShardedFlatIndex) and ix.n_shards == n
                   for ix in multi.indexes.values()), "no sharded index in the sharded runtime"
        assert all(getattr(e, "inner", e).n_replicas == n
                   for e in multi.dual_encoder.encoders.values()), "encode is not data-parallel"
        got, want = engine_answers(multi), engine_answers(single)
        for q, (texts, answer), (w_texts, w_answer) in zip(QUESTIONS, got, want):
            assert texts and texts == w_texts, f"retrieval diverged: {q!r}"
            assert answer == w_answer, f"answer diverged: {q!r}"

        # hold stream A open past its first answer delta, so stream B joins
        # the shared continuous decode; B must match the single runtime
        ga = multi.engine.query_stream(QUESTIONS[0], topn=3)
        for kind, _ in ga:
            if kind == "answer_delta":
                break
        deltas, final_b = [], None
        for kind, payload in multi.engine.query_stream(QUESTIONS[1], topn=3):
            if kind == "answer_delta":
                deltas.append(payload)
            elif kind == "complete":
                final_b = payload
        for _ in ga:
            pass
        stats = multi.engine.llm.stats()
        assert stats.get("engine_streams", 0) >= 1, f"stream B did not join: {stats}"
        assert final_b is not None and final_b["answer"].strip() == "".join(deltas).strip()
        assert final_b["answer"] == want[1][1], "streamed answer diverged"
        return {"questions": len(QUESTIONS), "joins": stats.get("engine_streams"),
                "answers": got}
    finally:
        for rt in (multi, single):
            inner = getattr(rt.engine.llm, "inner", None)
            if getattr(inner, "_engine", None) is not None:
                inner._engine.close()
            rt.feedback_db.flush_writes()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    backend, _ = launch.choose_backend(args.world, device.type)
    out = launch.spawn(train_rank, args.world, device=device, timeout_s=TIMEOUT_S)
    losses = [r["loss"] for r in out]
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    n = args.world
    base = Path(tempfile.mkdtemp(prefix="dryrun_engine_"))
    try:
        engine = full_engine(n, device, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps({"ok": True, "world": n, "backend": backend, **out[0],
                      "rank_devices": [r["device"] for r in out],
                      "sharded_search_shards": sharded_search(n, device),
                      "dp_encode_max_abs_diff": dp_encode(n, device),
                      "sharded_ivf_shards": sharded_ivf(n, device),
                      "decoder_tp": decoder_tp(n, device),
                      "engine": {k: engine[k] for k in ("questions", "joins")}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
