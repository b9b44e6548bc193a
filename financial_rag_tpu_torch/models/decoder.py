"""Causal decoder LM (Qwen2/Llama family) for on-device answer synthesis.

Counterpart of financial_rag_tpu/models/decoder.py in eager PyTorch: RMSNorm,
rotary embeddings, grouped-query attention and SwiGLU, with weights loaded
from a HuggingFace checkpoint. The casts follow the JAX package's order, so
the two packages compute the same function (held by
tests/test_torch_decoder.py).

Layout. The parameters are a plain dict: ``embed`` [V, H], ``final_ln``
[H], optionally ``lm_head`` [V, H], and ``layers``, a list with one dict per
layer (Linear weights as [in, out], so the forward is ``x @ w``).
``decoder_params_from_numpy`` takes the JAX package's pytree (layers
stacked on a leading axis) as numpy arrays. Weight-only int8 matrices are
``{"q": int8 [in, out], "s": f32 [out]}`` (the head: ``[V, H]`` and ``[V]``).

Execution. Where the JAX package scans over stacked layers inside one jitted
call, the port loops over the layer list in Python and drives generation
from the host: one device round trip per decode or verify step (to test for
eos, and for the prompt-lookup drafts, which run in numpy). Prefill
attention goes through K9 (ops/causal_flash.py) at every prompt length: on
CUDA the kernel, on the CPU its plain version. Decode and verify attention
(one or draft_k+1 new positions against the cache), RMSNorm, RoPE, SwiGLU
and the matmuls stay plain torch, as the JAX package left them to XLA.

Tensor parallelism. The JAX package annotates GSPMD shardings
(``shard_decoder_params``) and XLA inserts the collectives; the port runs one
process per rank (parallel/launch.py) and ``shard_decoder_params`` returns
this rank's slice of the Megatron split, tagged with a :class:`DecoderShard`
under ``params["tp"]``. The same layer functions then run on the rank's
``num_heads / tp`` query and ``num_kv_heads / tp`` kv heads (K9 on those in
the prefill) and ``intermediate_size / tp`` FFN columns: one f32 all-reduce
after the attention output product and one after the FFN down product, and
an all-gather of vocab-split logits, so that every rank of a model group
samples from the same logits. ``generate_tokens`` gathers the rows of
``shard_decoder_inputs`` back over the data axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.device import DeviceLike, resolve_device
from financial_rag_tpu_torch.ops.causal_flash import causal_flash_prefill
from financial_rag_tpu_torch.parallel import comm

_NEG = -1e30


@dataclass(frozen=True)
class DecoderConfig:
    """Architecture hyperparameters (HF config.json field names in parens)."""

    vocab_size: int = 32000            # vocab_size
    num_layers: int = 4                # num_hidden_layers
    hidden_size: int = 256             # hidden_size
    num_heads: int = 8                 # num_attention_heads
    num_kv_heads: int = 8              # num_key_value_heads (GQA when < heads)
    intermediate_size: int = 1024      # intermediate_size
    rope_theta: float = 10000.0        # rope_theta (Qwen2 ships 1e6)
    norm_eps: float = 1e-6             # rms_norm_eps
    attention_bias: bool = False       # q/k/v biases (True for Qwen2)
    tie_embeddings: bool = False       # tie_word_embeddings
    eos_token_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_hf_config(cls, hf: Mapping[str, Any]) -> "DecoderConfig":
        """Build from a HuggingFace config.json dict (Qwen2 or Llama)."""
        arch = (hf.get("architectures") or [""])[0].lower()
        eos = hf.get("eos_token_id", 2)
        if isinstance(eos, (list, tuple)):
            eos = eos[0]
        return cls(
            vocab_size=hf["vocab_size"],
            num_layers=hf["num_hidden_layers"],
            hidden_size=hf["hidden_size"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            intermediate_size=hf["intermediate_size"],
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            attention_bias=bool(hf.get("attention_bias", "qwen2" in arch)),
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
            eos_token_id=int(eos),
        )


# ------------------------------------------------------------------ params

def decoder_params_from_numpy(tree: Mapping[str, Any], *, dtype: torch.dtype = torch.float32,
                              device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's decoder pytree (``np.asarray`` over each leaf; split,
    fused or int8 ``{"q", "s"}`` layouts) -> the port's parameters on
    ``resolve_device(device)``. Float leaves take ``dtype``; int8 ``q`` stays
    int8 and its scales ``s`` f32."""
    device = resolve_device(device)

    def conv(a):
        if isinstance(a, Mapping):
            return {"q": torch.tensor(np.asarray(a["q"], np.int8), device=device),
                    "s": torch.tensor(np.asarray(a["s"], np.float32), device=device)}
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype, device=device)

    def at(leaf, i):   # layer i of a stacked leaf
        if isinstance(leaf, Mapping):
            return {"q": np.asarray(leaf["q"])[i], "s": np.asarray(leaf["s"])[i]}
        return np.asarray(leaf)[i]

    lay = tree["layers"]
    out: Dict[str, Any] = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: conv(at(v, i)) for k, v in lay.items()}
                     for i in range(len(np.asarray(lay["ln1"])))]
    return out


def random_decoder_params(cfg: DecoderConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Deterministic small-scale init from numpy: the same draws, in the same
    order, as the JAX package's random_decoder_params."""
    rng = np.random.default_rng(seed)
    h, kv = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim
    nl, ff = cfg.num_layers, cfg.intermediate_size

    def tn(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    embed = tn(cfg.vocab_size, h)
    layers = {"ln1": np.ones((nl, h), np.float32)}
    layers.update(q_w=tn(nl, h, h), k_w=tn(nl, h, kv), v_w=tn(nl, h, kv), o_w=tn(nl, h, h))
    layers["ln2"] = np.ones((nl, h), np.float32)
    layers.update(gate_w=tn(nl, h, ff), up_w=tn(nl, h, ff), down_w=tn(nl, ff, h))
    tree = {"embed": embed, "layers": layers, "final_ln": np.ones((h,), np.float32)}
    if cfg.attention_bias:
        layers.update(q_b=np.zeros((nl, h), np.float32), k_b=np.zeros((nl, kv), np.float32),
                      v_b=np.zeros((nl, kv), np.float32))
    if not cfg.tie_embeddings:
        tree["lm_head"] = tn(cfg.vocab_size, h)
    return decoder_params_from_numpy(tree, dtype=dtype, device=device)


def decoder_params_from_torch_state_dict(sd: Mapping[str, Any], cfg: DecoderConfig,
                                         dtype: torch.dtype = torch.float32,
                                         device: DeviceLike = None) -> Dict[str, Any]:
    """HF Qwen2ForCausalLM / LlamaForCausalLM state dict (torch tensors or
    numpy arrays) -> the port's parameters on ``resolve_device(device)``. HF
    stores Linear weights as [out, in]; the port keeps [in, out]."""
    device = resolve_device(device)

    def get(name: str) -> np.ndarray:
        t = sd[name]
        if hasattr(t, "detach"):
            return t.detach().cpu().float().numpy()
        return np.asarray(t, np.float32)

    p = "model.layers.{}."
    names = {"ln1": "input_layernorm.weight", "q_w": "self_attn.q_proj.weight",
             "k_w": "self_attn.k_proj.weight", "v_w": "self_attn.v_proj.weight",
             "o_w": "self_attn.o_proj.weight", "ln2": "post_attention_layernorm.weight",
             "gate_w": "mlp.gate_proj.weight", "up_w": "mlp.up_proj.weight",
             "down_w": "mlp.down_proj.weight"}
    if cfg.attention_bias:
        names.update(q_b="self_attn.q_proj.bias", k_b="self_attn.k_proj.bias",
                     v_b="self_attn.v_proj.bias")

    def conv(a):   # a writable C-order copy (safetensors arrays are read-only views)
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(device=device, dtype=dtype)

    layers = []
    for i in range(cfg.num_layers):
        layers.append({k: conv(get(p.format(i) + n).T if k.endswith("_w") else get(p.format(i) + n))
                       for k, n in names.items()})
    params: Dict[str, Any] = {"embed": conv(get("model.embed_tokens.weight")), "layers": layers,
                              "final_ln": conv(get("model.norm.weight"))}
    if not cfg.tie_embeddings:
        params["lm_head"] = conv(get("lm_head.weight"))
    return params


def quantize_decoder_params(params) -> Dict[str, Any]:
    """Weight-only int8 (symmetric, per output channel); bit-identical q and s
    to the JAX package's quantize_decoder_params. Embeddings, norms and
    biases stay as they are; the head ([V, H], the explicit lm_head or a
    SEPARATE copy of the tied embed table) gets per-vocab-row scales.
    Decode reads every weight once per step, so int8 halves those bytes;
    the matmul itself still runs in the activations' dtype (see ``_mm``)."""

    def quant(w, axis):   # in numpy f32, as the JAX package computes it
        wf = w.detach().float().cpu().numpy()
        s = np.maximum(np.max(np.abs(wf), axis=axis, keepdims=True) / 127.0, 1e-8)
        q = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
        return {"q": torch.from_numpy(q).to(w.device),
                "s": torch.from_numpy(np.squeeze(s, axis)).to(w.device)}

    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    out["layers"] = [{k: (quant(v, -2) if k.endswith("_w") else v) for k, v in lp.items()}
                     for lp in params["layers"]]
    out["lm_head"] = quant(params.get("lm_head", params["embed"]), -1)
    return out


def fuse_decoder_params(params) -> Dict[str, Any]:
    """Fuse q/k/v into one [H, H+2KV] matmul and gate/up into one [H, 2F]:
    fewer, longer weight streams per decode step. Exact for float weights
    (concatenation) and for weight-only int8 (the per-output-channel scales
    are independent per column)."""

    def cat(ws):
        if isinstance(ws[0], dict):
            return {"q": torch.cat([w["q"] for w in ws], -1),
                    "s": torch.cat([w["s"] for w in ws], -1)}
        return torch.cat(ws, -1)

    layers = []
    for lp in params["layers"]:
        fused = {k: v for k, v in lp.items()
                 if k not in ("q_w", "k_w", "v_w", "gate_w", "up_w", "q_b", "k_b", "v_b")}
        fused["qkv_w"] = cat([lp["q_w"], lp["k_w"], lp["v_w"]])
        if "q_b" in lp:
            fused["qkv_b"] = torch.cat([lp["q_b"], lp["k_b"], lp["v_b"]], -1)
        fused["gu_w"] = cat([lp["gate_w"], lp["up_w"]])
        layers.append(fused)
    return dict(params, layers=layers)


# ----------------------------------------------------------------- forward

def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain or weight-only-int8 weights. The int8 form casts the
    whole weight to x's dtype on every call (a copy the size of the bf16
    weight); a fused dequantising matmul is later work."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def _qkv(h: torch.Tensor, lp, cfg: DecoderConfig):
    """(q, k, v) projections from either the fused or the split layout."""
    kv = cfg.num_kv_heads * cfg.head_dim
    if "qkv_w" in lp:
        qkv = _mm(h, lp["qkv_w"])
        if "qkv_b" in lp:
            qkv = qkv + lp["qkv_b"]
        return (qkv[..., :cfg.hidden_size], qkv[..., cfg.hidden_size:cfg.hidden_size + kv],
                qkv[..., cfg.hidden_size + kv:])
    q, k, v = _mm(h, lp["q_w"]), _mm(h, lp["k_w"]), _mm(h, lp["v_w"])
    if cfg.attention_bias:
        q, k, v = q + lp["q_b"], k + lp["k_b"], v + lp["v_b"]
    return q, k, v


def _row_parallel(x: torch.Tensor, w, shard: Optional["DecoderShard"]) -> torch.Tensor:
    """x @ w, where under tensor parallelism w holds this rank's input rows:
    the partial product in f32 (one bf16 GEMM with an f32 output on the
    GPU), summed over the model axis in f32, cast to x's dtype."""
    if shard is None or shard.tp == 1:
        return _mm(x, w)
    if x.is_cuda and x.dtype != torch.float32:
        part = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        part = part.view(*x.shape[:-1], w.shape[-1])
    else:
        part = x.float() @ w.float()
    return comm.all_reduce_(part, shard.mesh, shard.model_axis).to(x.dtype)


def _ffn(h: torch.Tensor, lp, cfg: DecoderConfig,
         shard: Optional["DecoderShard"] = None) -> torch.Tensor:
    """SwiGLU from either the fused or the split layout."""
    if "gu_w" in lp:
        gu = _mm(h, lp["gu_w"])
        gate, up = gu[..., :cfg.intermediate_size], gu[..., cfg.intermediate_size:]
        return _mm(torch.nn.functional.silu(gate) * up, lp["down_w"])
    act = torch.nn.functional.silu(_mm(h, lp["gate_w"])) * _mm(h, lp["up_w"])
    return _row_parallel(act, lp["down_w"], shard)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * scale


def _rope_tables(positions: torch.Tensor, theta: float, d: int):
    """(cos, sin) f32 [B, S, 1, D/2] for ``positions`` [B, S], computed once
    per forward or step and shared by every layer's q and k."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding (HF convention), in f32. x: [B, S, H, D]."""
    d = x.shape[-1]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attend(q, k, v, mask, cfg: DecoderConfig):
    """q: [B,S,H,D]; k, v: [B,T,KV,D]; mask: [B,S,T] bool (True = attend).

    GQA contracts against the un-replicated k/v (q reshaped to
    [B,S,KV,G,D]). Scores come out of the einsum in q's dtype and are
    divided in f32, as the JAX package's numpy-scalar division promotes."""
    b, s = q.shape[:2]
    groups = cfg.num_heads // cfg.num_kv_heads
    scale = math.sqrt(cfg.head_dim)
    if groups > 1:
        qg = q.reshape(b, s, cfg.num_kv_heads, groups, cfg.head_dim)
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / scale
        scores = torch.where(mask[:, None, None], scores, _NEG)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
        return out.reshape(b, s, cfg.num_heads, cfg.head_dim)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() / scale
    scores = torch.where(mask[:, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _layer(x, lp, rope, mask, cfg: DecoderConfig, attend=None, shard=None):
    """One decoder layer over a whole sequence (no cache before it).

    Returns (x_out, k_new, v_new), k_new/v_new [B, S, KV, D] being this
    layer's post-rope keys and values for the cache. ``attend`` replaces
    the masked ``_attend`` (prefill passes K9, which carries its own mask).
    Under tensor parallelism ``cfg`` is the rank's local config and
    ``shard`` its DecoderShard."""
    b, s, _ = x.shape
    cos, sin = rope
    h = _rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    q = _rope_apply(q.reshape(b, s, cfg.num_heads, cfg.head_dim), cos, sin)
    k = _rope_apply(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), cos, sin)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if attend is not None:
        attn = attend(q, k, v)
    else:
        attn = _attend(q, k, v, mask, cfg)
    x = x + _row_parallel(attn.reshape(b, s, cfg.hidden_size), lp["o_w"], shard)
    h = _rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(h, lp, cfg, shard), k, v


def _logits(params, x, cfg: DecoderConfig):
    x = _rms_norm(x, params["final_ln"], cfg.norm_eps)
    # a quantized model carries its own int8 "lm_head" (see
    # quantize_decoder_params); a tied float model reads the embed table
    head = params.get("lm_head", params["embed"])
    if isinstance(head, dict):
        raw = x @ head["q"].to(x.dtype).T
        return (raw * head["s"].to(x.dtype)).float()
    logits = (x @ head.T).float()
    shard = params.get("tp")
    if shard is not None and shard.vocab_split:
        logits = comm.all_gather(logits, shard.mesh, shard.model_axis, dim=-1)
    return logits


@torch.inference_mode()
def decoder_forward(params, input_ids, cfg: DecoderConfig,
                    attention_mask: Optional[torch.Tensor] = None):
    """Full-sequence causal forward -> f32 logits [B, S, V]. ``attention_mask``
    marks real tokens (1) and LEFT padding (0); positions count real tokens,
    so left-padded prompts match HF."""
    cfg, shard = _local(params, cfg)
    b, s = input_ids.shape
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids).to(device=dev, dtype=torch.long)
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    attention_mask = torch.as_tensor(attention_mask).to(device=dev, dtype=torch.int32)
    positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))[None]
    mask = causal & (attention_mask[:, None, :] == 1)
    x = params["embed"][input_ids]
    rope = _rope_tables(positions, cfg.rope_theta, cfg.head_dim)
    for lp in params["layers"]:
        x, _, _ = _layer(x, lp, rope, mask, cfg, shard=shard)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------- generate

def _prefill(params, input_ids, attention_mask, max_total: int, cfg: DecoderConfig):
    """Run the LEFT-padded prompt; return (last-position logits [B, V], k
    cache, v cache). The caches are allocated once for the whole generation,
    [L, B, max_total, KV, D], and every later step writes its slots in
    place. Attention goes through K9 with ``pad_len`` = the count of
    padding zeros of each row, which equals ``tril & (mask == 1)`` when the
    zeros form a prefix (what every caller builds)."""
    cfg, shard = _local(params, cfg)
    b, s = input_ids.shape
    positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp_min(0)
    x = params["embed"][input_ids]
    rope = _rope_tables(positions, cfg.rope_theta, cfg.head_dim)
    pad_len = (s - attention_mask.sum(dim=1)).to(torch.int32)

    def attend(q, k, v):
        return causal_flash_prefill(
            q.reshape(b, s, -1), k.reshape(b, s, -1), v.contiguous().reshape(b, s, -1),
            pad_len, num_q_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        ).reshape(b, s, cfg.num_heads, cfg.head_dim)

    shape = (len(params["layers"]), b, max_total, cfg.num_kv_heads, cfg.head_dim)
    k_cache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    v_cache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, k_new, v_new = _layer(x, lp, rope, None, cfg, attend=attend, shard=shard)
        k_cache[i, :, :s] = k_new
        v_cache[i, :, :s] = v_new
    return _logits(params, x[:, -1:], cfg)[:, 0], k_cache, v_cache


def _cached_block(params, toks, positions, slot0: int, k_cache, v_cache, mask,
                  cfg: DecoderConfig):
    """Feed toks [B, S] at rotary ``positions`` [B, S]: write their k/v into
    cache slots [slot0, slot0+S) in place, attend under ``mask`` [B, S, T],
    return f32 logits [B, S, V]."""
    cfg, shard = _local(params, cfg)
    b, s = toks.shape
    x = params["embed"][toks.long()]
    cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim)
    for i, lp in enumerate(params["layers"]):
        hh = _rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(hh, lp, cfg)
        q = _rope_apply(q.reshape(b, s, cfg.num_heads, cfg.head_dim), cos, sin)
        k_cache[i, :, slot0:slot0 + s] = _rope_apply(
            k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), cos, sin)
        v_cache[i, :, slot0:slot0 + s] = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        attn = _attend(q, k_cache[i], v_cache[i], mask, cfg).reshape(b, s, cfg.hidden_size)
        x = x + _row_parallel(attn, lp["o_w"], shard)
        hh = _rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(hh, lp, cfg, shard)
    return _logits(params, x, cfg)


def _decode_one(params, token, pos, slot: int, k_cache, v_cache, prompt_mask,
                cfg: DecoderConfig):
    """One decode step. token [B]; pos [B] rotary positions of ``token``
    (real-token counts, so left padding does not shift the rotation); slot:
    the cache slot to write, uniform across the batch (the cache is laid out
    in padded coordinates). Attention masks slots past this step and the
    prompt's padding slots. Returns f32 logits [B, V]."""
    max_total = k_cache.shape[2]
    valid = torch.arange(max_total, device=token.device)[None, :] <= slot
    mask = (valid & prompt_mask)[:, None, :]
    return _cached_block(params, token[:, None], pos[:, None], slot, k_cache, v_cache,
                         mask, cfg)[:, 0]


def _verify_block(params, toks, pos0: int, slot0: int, k_cache, v_cache, prompt_mask,
                  cfg: DecoderConfig):
    """Decode S tokens in one pass (batch 1): feed toks [1, S] at slots
    [slot0, slot0+S), return logits [S, V] at every position. Position i
    attends slot j iff j <= slot0 + i and j is not prompt padding. The
    block streams the same weights as a one-token step, so verifying
    draft_k drafted tokens costs about one step."""
    s = toks.shape[1]
    dev = toks.device
    positions = pos0 + torch.arange(s, device=dev)[None, :]
    jslots = torch.arange(k_cache.shape[2], device=dev)[None, None, :]
    mask = (jslots <= (slot0 + torch.arange(s, device=dev))[None, :, None]) \
        & prompt_mask[:, None, :]
    return _cached_block(params, toks, positions, slot0, k_cache, v_cache, mask, cfg)[0]


def _verify_block_rows(params, toks, pos0, slot0: int, k_cache, v_cache, prompt_mask,
                       cfg: DecoderConfig):
    """_verify_block over a row batch with per-row rotary positions: toks
    [B, S], pos0 [B], slot0 one write slot shared by every row (the
    continuous engine's shared-write-head layout). Writes the block's k/v
    at [slot0, slot0+S) of every row in place and returns f32 logits [B, S,
    V]. Position i of a row attends cache slot j iff j <= slot0 + i and the
    row's prompt mask allows j, which also hides a row's left padding and
    the slots an earlier speculative block rejected for it."""
    s = toks.shape[1]
    dev = toks.device
    steps = torch.arange(s, device=dev)
    positions = pos0[:, None] + steps[None, :]
    jslots = torch.arange(k_cache.shape[2], device=dev)[None, None, :]
    mask = (jslots <= (slot0 + steps)[None, :, None]) & prompt_mask[:, None, :]
    return _cached_block(params, toks, positions, slot0, k_cache, v_cache, mask, cfg)


def _sample(logits, generator: Optional[torch.Generator], temperature: float, top_k: int):
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k > 0:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < vals[..., -1:], _NEG, logits)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _inputs(params, input_ids, attention_mask):
    dev = params["embed"].device
    return (torch.as_tensor(input_ids).to(device=dev, dtype=torch.long),
            torch.as_tensor(attention_mask).to(device=dev, dtype=torch.int32))


def _generator(generator, temperature: float, device) -> Optional[torch.Generator]:
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


class _Greedy:
    """Batch decode state shared by generate_tokens and generate_stream:
    the caches, the last sampled token (not yet fed), the rows' done flags
    and the number of steps fed so far."""

    def __init__(self, params, input_ids, attention_mask, generator, cfg, total_new: int,
                 temperature: float, top_k: int):
        ids, am = _inputs(params, input_ids, attention_mask)
        b, s = ids.shape
        self.params, self.cfg = params, cfg
        self.temperature, self.top_k = temperature, top_k
        self.gen = _generator(generator, temperature, ids.device)
        last, self.kc, self.vc = _prefill(params, ids, am, s + total_new, cfg)
        self.pm = torch.cat([am == 1, torch.ones((b, total_new), dtype=torch.bool,
                                                 device=ids.device)], dim=1)
        self.pos0 = am.sum(dim=1)
        self.slot0 = s
        self.g = 0
        self.tok = _sample(last, self.gen, temperature, top_k)
        self.done = self.tok == cfg.eos_token_id

    def step(self) -> torch.Tensor:
        logits = _decode_one(self.params, self.tok, self.pos0 + self.g, self.slot0 + self.g,
                             self.kc, self.vc, self.pm, self.cfg)
        nxt = _sample(logits, self.gen, self.temperature, self.top_k)
        nxt = torch.where(self.done, self.cfg.eos_token_id, nxt).to(torch.int32)
        self.done = self.done | (nxt == self.cfg.eos_token_id)
        self.g += 1
        self.tok = nxt
        return nxt


@torch.inference_mode()
def generate_tokens(params, input_ids, attention_mask, generator: Optional[torch.Generator] = None,
                    *, cfg: DecoderConfig, max_new_tokens: int, temperature: float = 0.0,
                    top_k: int = 0) -> torch.Tensor:
    """Prefill + up to max_new_tokens decode steps -> int32 [B, max_new_tokens].

    input_ids / attention_mask: [B, S] LEFT-padded prompts. Once a row emits
    eos it keeps emitting eos, so trimmed output does not depend on
    max_new_tokens; when every row is done the remaining steps are skipped
    and filled with eos (the same tokens the JAX package's full scan gives).
    ``generator`` seeds sampling (temperature > 0); greedy ignores it. On
    ``shard_decoder_params`` params, with ``shard_decoder_inputs`` rows,
    every rank returns the whole batch, as the JAX function returns the
    global array; without a generator each rank seeds its own with 0."""
    st = _Greedy(params, input_ids, attention_mask, generator, cfg, max_new_tokens,
                 temperature, top_k)
    toks = [st.tok]
    for _ in range(max_new_tokens - 1):
        if bool(st.done.all()):
            break
        toks.append(st.step())
    out = torch.stack(toks, dim=1)
    if out.shape[1] < max_new_tokens:
        out = torch.nn.functional.pad(out, (0, max_new_tokens - out.shape[1]),
                                      value=cfg.eos_token_id)
    shard = params.get("tp")
    if shard is not None:   # shard_decoder_inputs' rows, back in data-rank order
        for axis in shard.mesh.axis_names:
            if axis != shard.model_axis:
                out = comm.all_gather(out, shard.mesh, axis)
    return out


# ------------------------------------------- speculative (prompt-lookup)

def _pl_drafts(ctx: np.ndarray, slot: int, valid_from: int, *, ngram: int,
               draft_k: int) -> np.ndarray:
    """Prompt-lookup drafting: find the most recent earlier occurrence of the
    sequence's last ``ngram`` tokens (falling back to ngram-1, then to no
    match) and propose the ``draft_k`` tokens that followed it. ctx [T]: fed
    tokens by cache slot, the pending token already at ``slot``; valid_from:
    the first non-padding slot. Drafts only decide how many tokens a step
    accepts, never which: the verify step recomputes each one. Reads past
    the sequence end clamp as the JAX package's dynamic_slice does."""
    t = ctx.shape[0]
    idx = np.arange(t)

    def match_end(n):
        m = idx < slot
        for d in range(n):
            tgt = ctx[max(slot - d, 0)]
            m &= (ctx[np.maximum(idx - d, 0)] == tgt) & (idx - d >= valid_from)
        hits = idx[m]
        return int(hits.max()) if hits.size else -1

    e = match_end(ngram)
    if ngram > 1 and e < 0:
        e = match_end(ngram - 1)
    start = min(e + 1 if e >= 0 else 0, t - draft_k)
    return ctx[start:start + draft_k]


def _update(buf: np.ndarray, values: np.ndarray, start: int) -> None:
    """buf[start:start+len(values)] = values, the start clamped so the
    update fits (the JAX package's dynamic_update_slice)."""
    start = min(max(start, 0), buf.shape[0] - values.shape[0])
    buf[start:start + values.shape[0]] = values


class _Spec:
    """Batch-1 prompt-lookup speculation state: the caches on the device,
    the fed-token context and the bookkeeping on the host."""

    def __init__(self, params, input_ids, attention_mask, cfg: DecoderConfig,
                 max_new_tokens: int, draft_k: int, ngram: int):
        ids, am = _inputs(params, input_ids, attention_mask)
        b, s = ids.shape
        if b != 1:
            raise ValueError(f"speculative decoding is a batch-1 path, got batch {b}")
        self.params, self.cfg, self.draft_k, self.ngram = params, cfg, draft_k, ngram
        self.blk = draft_k + 1
        # slack so a final overshooting block never writes past the buffers
        last, self.kc, self.vc = _prefill(params, ids, am, s + max_new_tokens + self.blk, cfg)
        self.pm = torch.cat([am == 1, torch.ones((1, max_new_tokens + self.blk),
                                                 dtype=torch.bool, device=ids.device)], dim=1)
        self.pos = int(am.sum())                 # rotary position of the pending token
        self.valid_from = s - self.pos           # first real slot
        self.slot = s                            # cache slot of the pending token
        self.tok = int(torch.argmax(last[0]))
        self.done = self.tok == cfg.eos_token_id
        self.ctx = np.concatenate([ids[0].cpu().numpy().astype(np.int64),
                                   np.zeros(max_new_tokens + self.blk, np.int64)])
        self.budget = self.ctx.shape[0]          # slots; never write past

    def step(self):
        """One verify step: returns (the blk-long emitted block, i.e. the
        accepted tokens then eos padding, and how many of them count)."""
        eos, k = self.cfg.eos_token_id, self.draft_k
        self.ctx[self.slot] = self.tok
        drafts = _pl_drafts(self.ctx, self.slot, self.valid_from, ngram=self.ngram, draft_k=k)
        block = torch.tensor(np.concatenate([[self.tok], drafts])[None], dtype=torch.long,
                             device=self.kc.device)
        logits = _verify_block(self.params, block, self.pos, self.slot, self.kc, self.vc,
                               self.pm, self.cfg)
        preds = torch.argmax(logits, dim=-1).cpu().numpy()
        acc = int(np.cumprod(drafts == preds[:k]).sum())
        is_eos = preds == eos
        first_eos = int(np.argmax(is_eos)) if is_eos.any() else self.blk
        n_emit = min(acc + 1, first_eos + 1)
        emit = np.where(np.arange(self.blk) < n_emit, preds, eos)
        # fed tokens for later lookups (slots past slot+n_emit hold eos
        # padding until overwritten; lookups never match there)
        _update(self.ctx, emit, self.slot + 1)
        self.tok, self.done = int(emit[n_emit - 1]), bool(is_eos[n_emit - 1])
        self.slot += n_emit
        self.pos += n_emit
        return emit, n_emit


@torch.inference_mode()
def generate_tokens_spec(params, input_ids, attention_mask, *, cfg: DecoderConfig,
                         max_new_tokens: int, draft_k: int = 7, ngram: int = 3):
    """Greedy generation with prompt-lookup speculative decoding (batch 1).
    Returns (tokens int32 [1, max_new_tokens] on the CPU, verify steps).

    Each step feeds the pending token and draft_k tokens drafted by n-gram
    match against the sequence so far, verifies them in one
    ``_verify_block``, and emits the accepted prefix plus one. The output,
    trimmed at eos, is greedy ``generate_tokens`` output: exactly so in
    exact arithmetic; under bf16 a near-tie may resolve differently between
    the S-token block and the one-token step, as in any batched-verify
    speculative decoder."""
    st = _Spec(params, input_ids, attention_mask, cfg, max_new_tokens, draft_k, ngram)
    out = np.full(max_new_tokens + st.blk, cfg.eos_token_id, np.int64)
    out[0] = st.tok
    g, steps = 1, 0
    while not st.done and g < max_new_tokens:
        emit, n = st.step()
        _update(out, emit, g)
        g += n
        steps += 1
    return torch.from_numpy(out[None, :max_new_tokens].astype(np.int32)), steps


def _spec_segment(st: _Spec, out: np.ndarray, g: int, segment: int):
    """Verify steps until >= segment tokens land in out (or eos, or the
    cache budget ends); returns the count in out."""
    while not st.done and g < segment and st.slot + st.blk < st.budget:
        emit, n = st.step()
        _update(out, emit, g)
        g += n
    return g


@torch.inference_mode()
def generate_stream_spec(params, input_ids, attention_mask, *, cfg: DecoderConfig,
                         max_new_tokens: int, segment: int = 48, draft_k: int = 7,
                         ngram: int = 3):
    """Streaming speculative greedy generation (batch 1). Yields int32
    numpy blocks [1, n]; their concatenation, trimmed at eos, equals greedy
    ``generate_tokens`` output (see generate_tokens_spec on bf16 near-ties).
    Each block is one segment of verify steps."""
    seg = max(1, min(segment, max_new_tokens))
    st = _Spec(params, input_ids, attention_mask, cfg, max_new_tokens, draft_k, ngram)
    eos = cfg.eos_token_id
    out = np.full(seg + st.blk, eos, np.int64)
    out[0] = st.tok
    n = _spec_segment(st, out, 1, seg)
    emitted = 0
    while True:
        keep = min(n, max_new_tokens - emitted)
        if keep > 0:
            yield out[None, :keep].astype(np.int32)
            emitted += keep
        if emitted >= max_new_tokens:
            return
        if keep and out[keep - 1] == eos:
            return
        if n == 0:                      # no progress: the budget is spent
            return
        out = np.full(seg + st.blk, eos, np.int64)
        n = _spec_segment(st, out, 0, seg)


# ------------------------------------------------------------- streaming

@torch.inference_mode()
def generate_stream(params, input_ids, attention_mask, generator: Optional[torch.Generator] = None,
                    *, cfg: DecoderConfig, max_new_tokens: int, segment: int = 48,
                    temperature: float = 0.0, top_k: int = 0):
    """Yield int32 numpy token blocks [B, <=segment]; concatenated they equal
    ``generate_tokens`` (the same draws from ``generator`` per step). The
    cache is sized for the whole stream up front. Stops once every row has
    emitted eos (seen in the block itself)."""
    seg = max(1, min(segment, max_new_tokens))
    total_new = math.ceil(max_new_tokens / seg) * seg
    st = _Greedy(params, input_ids, attention_mask, generator, cfg, total_new,
                 temperature, top_k)
    toks = [st.tok] + [st.step() for _ in range(seg - 1)]
    emitted = 0
    while True:
        block = torch.stack(toks, dim=1).cpu().numpy()
        keep = min(block.shape[1], max_new_tokens - emitted)
        yield block[:, :keep]
        emitted += keep
        if emitted >= max_new_tokens:
            return
        if (block[:, -1] == cfg.eos_token_id).all():
            return                      # every row finished mid-stream
        toks = [st.step() for _ in range(seg)]


# ------------------------------------------------------- tensor parallelism

@dataclass(frozen=True)
class DecoderShard:
    """This rank's place in a tensor-parallel decoder: the mesh, its model
    axis, and whether the untied head's vocab rows are split over it."""

    mesh: Any
    model_axis: str
    vocab_split: bool

    @property
    def tp(self) -> int:
        return comm.axis_size(self.mesh, self.model_axis)


def _local(params, cfg: DecoderConfig) -> Tuple[DecoderConfig, Optional[DecoderShard]]:
    """(the config of this rank's heads and FFN columns, its DecoderShard);
    (cfg, None) for unsharded params."""
    shard = params.get("tp")
    if shard is None or shard.tp == 1:
        return cfg, shard
    tp = shard.tp
    return replace(cfg, hidden_size=cfg.hidden_size // tp, num_heads=cfg.num_heads // tp,
                   num_kv_heads=cfg.num_kv_heads // tp,
                   intermediate_size=cfg.intermediate_size // tp), shard


# the leaves split on output features (columns) and on input rows
_COLUMN_LEAVES = ("q_w", "k_w", "v_w", "gate_w", "up_w", "q_b", "k_b", "v_b")
_ROW_LEAVES = ("o_w", "down_w")


def shard_decoder_params(params, mesh, cfg: DecoderConfig, model_axis: str = "model"):
    """This rank's slice of ``params`` for tensor parallelism over
    ``model_axis`` of ``mesh`` (a parallel.Mesh): the Megatron split of the
    JAX package's shard_decoder_params. q/k/v (and their biases) and
    gate/up keep this rank's output features (heads, FFN columns), o and
    down its input rows, so each layer needs one all-reduce after attention
    and one after the FFN; embed, the norms and a tied head are replicated;
    an untied lm_head keeps its vocab rows when the vocabulary divides
    evenly, else it is replicated. kv heads must divide the axis (asserted,
    as in the JAX package), so GQA groups stay on one rank. Takes the split
    float layout: the fused and int8 layouts raise ValueError."""
    tp = comm.axis_size(mesh, model_axis)
    assert cfg.num_kv_heads % tp == 0, (
        f"num_kv_heads={cfg.num_kv_heads} not divisible by {model_axis}={tp}")
    if cfg.intermediate_size % tp:
        raise ValueError(f"intermediate_size={cfg.intermediate_size} not divisible by "
                         f"{model_axis}={tp}")
    layers = params["layers"]
    if any(isinstance(v, dict) for lp in layers for v in lp.values()) or isinstance(
            params.get("lm_head"), dict) or any("qkv_w" in lp or "gu_w" in lp for lp in layers):
        raise ValueError("shard_decoder_params takes the split float layout "
                         "(not fuse_decoder_params' or quantize_decoder_params' output)")
    m = mesh.index(model_axis) if tp > 1 else 0

    def part(t, dim):
        n = t.shape[dim] // tp
        return t.narrow(dim, m * n, n).clone(memory_format=torch.contiguous_format)

    def local(name, t):
        if tp == 1:
            return t
        if name in _COLUMN_LEAVES:
            return part(t, t.dim() - 1)
        if name in _ROW_LEAVES:
            return part(t, 0)
        return t

    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    out["layers"] = [{k: local(k, v) for k, v in lp.items()} for lp in layers]
    vocab_split = False
    if "lm_head" in params:
        vocab_split = tp > 1 and cfg.vocab_size % tp == 0
        out["lm_head"] = part(params["lm_head"], 0) if vocab_split else params["lm_head"]
    out["tp"] = DecoderShard(mesh, model_axis, vocab_split)
    return out


def shard_decoder_inputs(input_ids, attention_mask, mesh, data_axis: str = "data"):
    """This rank's rows of the batch over ``data_axis`` (replicated over the
    model axis), as torch tensors; the batch must divide evenly."""
    ids, am = torch.as_tensor(input_ids), torch.as_tensor(attention_mask)
    n = comm.axis_size(mesh, data_axis)
    if ids.shape[0] % n:
        raise ValueError(f"batch {ids.shape[0]} not divisible by {data_axis}={n}")
    rows = ids.shape[0] // n
    i = mesh.index(data_axis) if n > 1 else 0
    return ids[i * rows:(i + 1) * rows], am[i * rows:(i + 1) * rows]
