"""BERT encoder stack in PyTorch (functional, on a parameter tree).

Counterpart of financial_rag_tpu/models/bert.py. Parameters keep the JAX
package's stacked layout (every layer leaf has a leading num_layers axis);
the layer stack is a Python loop over it instead of ``lax.scan``.

There is no attention-implementation policy: every layer calls the kernel
wrappers (ops/flash_attention, ops/fused_ffn, ops/pool_norm), which launch
the hand-written CUDA kernels for CUDA tensors at every sequence length and
run the plain PyTorch versions for CPU tensors. The JAX package's seq >= 256
cut-off (resolve_attention_impl) was a TPU tuning and has no counterpart.
Activations run in the compute dtype (bf16 on the GPU) with float32 layer
norms and float32 matmul accumulation.

Training runs the same forward on the float32 master tree (each matmul
casts its weight to the compute dtype per call, as the JAX package does);
attention and the FFN are autograd Functions (K2/K10, K3 with a
rematerialising backward). The fused pooling kernel (K1) has no backward,
so training pools with the plain mean (``fused_pool=False``), as the JAX
package's training pools through XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.ops.flash_attention import flash_attention
from financial_rag_tpu_torch.ops.fused_ffn import fused_ffn
from financial_rag_tpu_torch.ops.pool_norm import (masked_mean_l2_normalize,
                                                   masked_mean_l2_normalize_plain)

# A BertParams is a nested dict of tensors:
# {
#   "embeddings": {word, position, token_type, ln_scale, ln_bias},
#   "layers": {q_w,q_b,k_w,k_b,v_w,v_b,o_w,o_b,attn_ln_scale,attn_ln_bias,
#              ffn_in_w,ffn_in_b,ffn_out_w,ffn_out_b,ffn_ln_scale,ffn_ln_bias}
#             (every leaf has leading axis = num_layers),
#   "pooler": {w, b}            (optional — BertPooler dense+tanh)
#   "classifier": {w, b}        (optional — sequence classification head)
# }
BertParams = Dict[str, Any]

NEG_INF = -1e9

# layer leaves that enter a matmul (or its bias) in the compute dtype
MATMUL_LEAVES = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b",
                 "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b")


def prepare_params(params: BertParams, *, device, compute_dtype: torch.dtype) -> BertParams:
    """Device copy of a parameter tree for inference. The matmul weights and
    biases of the layer stack are cast to the compute dtype once here (the
    JAX package casts them on every call; the values are the same), every
    other leaf stays float32, and every leaf is contiguous and detached
    from any training graph."""
    out: BertParams = {}
    for group, leaves in params.items():
        out[group] = {}
        for name, t in leaves.items():
            dt = compute_dtype if group == "layers" and name in MATMUL_LEAVES else torch.float32
            out[group][name] = t.detach().to(device=device, dtype=dt).contiguous()
    return out


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32 (biased variance, as the JAX package), back in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return x @ w.to(dt) + b.to(dt)


def _encoder_layer(x, mask_bias, lp, *, num_heads: int, eps: float):
    """One post-LN BERT layer. lp: this layer's slice of the stacked params."""
    q = _dense(x, lp["q_w"], lp["q_b"])
    k = _dense(x, lp["k_w"], lp["k_b"])
    v = _dense(x, lp["v_w"], lp["v_b"])
    attn = flash_attention(q, k, v, mask_bias, num_heads=num_heads)
    attn = _dense(attn, lp["o_w"], lp["o_b"])
    x = _layer_norm(x + attn, lp["attn_ln_scale"], lp["attn_ln_bias"], eps)
    h = fused_ffn(x, lp["ffn_in_w"], lp["ffn_in_b"], lp["ffn_out_w"], lp["ffn_out_b"])
    return _layer_norm(x + h, lp["ffn_ln_scale"], lp["ffn_ln_bias"], eps)


def bert_forward(
    params: BertParams,
    input_ids: torch.Tensor,        # [B, S] int
    attention_mask: torch.Tensor,   # [B, S] int/bool
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    config: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Full encoder stack -> last hidden states [B, S, H] in compute_dtype."""
    emb = params["embeddings"]
    b, s = input_ids.shape
    input_ids = input_ids.long()
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    # F.embedding rather than indexing: on the H100 the backward of indexing
    # (indexing_backward_kernel) took 45 of a 309 ms contrastive step (PERF.md)
    x = (F.embedding(input_ids, emb["word"])
         + emb["position"][:s][None, :, :]
         + F.embedding(token_type_ids.long(), emb["token_type"]))
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], config.layer_norm_eps)
    x = x.to(compute_dtype)

    mask_bias = torch.where(attention_mask > 0, 0.0, NEG_INF).to(torch.float32)  # [B, S]
    layers = params["layers"]
    for i in range(layers["q_w"].shape[0]):
        lp = {name: leaf[i] for name, leaf in layers.items()}
        x = _encoder_layer(x, mask_bias, lp, num_heads=config.num_heads,
                           eps=config.layer_norm_eps)
    return x


def pool_hidden(hidden: torch.Tensor, attention_mask: torch.Tensor, pooling: str, *,
                fused_pool: bool = True) -> torch.Tensor:
    """Pool + L2-normalize -> [B, H] float32 unit vectors. Mean pooling runs
    the fused kernel (K1, no backward) unless ``fused_pool`` is False, which
    takes K1's differentiable plain version, the formula of the JAX
    package's XLA path."""
    if pooling == "cls":
        pooled = hidden[:, 0, :].float()
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if pooling == "mean":
        if fused_pool:
            return masked_mean_l2_normalize(hidden.contiguous(), attention_mask)
        return masked_mean_l2_normalize_plain(hidden, attention_mask)
    raise ValueError(f"unknown pooling mode: {pooling}")


def bert_encode(
    params: BertParams,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    config: ModelConfig,
    pooling: str = "mean",
    compute_dtype: torch.dtype = torch.float32,
    fused_pool: bool = True,
) -> torch.Tensor:
    """Sentence-embedding forward: encoder stack -> pool -> L2 norm. [B, H] f32."""
    hidden = bert_forward(params, input_ids, attention_mask, token_type_ids,
                          config=config, compute_dtype=compute_dtype)
    return pool_hidden(hidden, attention_mask, pooling, fused_pool=fused_pool)


def cross_encoder_forward(
    params: BertParams,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: torch.Tensor,
    *,
    config: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sequence-classification forward (relevance logits [B]): encoder ->
    pooler (dense+tanh on CLS) -> classifier, as BertForSequenceClassification."""
    hidden = bert_forward(params, input_ids, attention_mask, token_type_ids,
                          config=config, compute_dtype=compute_dtype)
    cls = hidden[:, 0, :].float()
    pooled = torch.tanh(cls @ params["pooler"]["w"].float() + params["pooler"]["b"].float())
    logits = pooled @ params["classifier"]["w"].float() + params["classifier"]["b"].float()
    return logits[:, 0] if logits.ndim == 2 and logits.shape[-1] == 1 else logits


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Bundles a checkpoint's config with its pooling behavior."""

    config: ModelConfig
    pooling: str  # "cls" (bge) | "mean" (gte)

    @staticmethod
    def bge(config: ModelConfig) -> "EncoderSpec":
        return EncoderSpec(config=config, pooling="cls")

    @staticmethod
    def gte(config: ModelConfig) -> "EncoderSpec":
        return EncoderSpec(config=config, pooling="mean")
