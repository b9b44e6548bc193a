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

Tensor parallelism (``tp``: a parallel.Mesh whose model axis is larger than
1, or a (mesh, model axis name) pair) runs the JAX package's ``pallas_tp``
layer on this rank's parameter shards (training/contrastive.shard_params):
q, k and v column-parallel behind one ``copy_to_model``, attention K11 on
the local heads, ``o`` row-parallel (the partial product in f32,
all-reduced in f32, then cast, then ``o_b`` added once), replicated layer
norms, and the column/row-parallel ``dense -> erf GELU -> dense`` FFN that
the JAX package's TP path runs through XLA (``use_fused_ffn`` is True only
for ``attention_impl == "pallas"``, bert.py:160-161), so K3 does not run
there. The replicated embedding tables take a backward whose bits do not
change between runs (:class:`_ReplicatedEmbedding`), so the model ranks'
copies stay identical with no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.ops.flash_attention import flash_attention, flash_attention_tp
from financial_rag_tpu_torch.ops.fused_ffn import fused_ffn
from financial_rag_tpu_torch.ops.pool_norm import (masked_mean_l2_normalize,
                                                   masked_mean_l2_normalize_plain)
from financial_rag_tpu_torch.parallel import comm

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


class _PartialProduct(torch.autograd.Function):
    """``x @ w`` in float32 from operands in x's dtype: a row-parallel
    dense's partial product, which the model axis sums in float32 (the JAX
    dot's ``preferred_element_type=float32``). A bf16 product on the GPU is
    one bf16 GEMM with a float32 output. The incoming gradient is a float32
    copy of a gradient in x's dtype (the cast after the sum), so the
    backward GEMMs run in x's dtype without rounding it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dtype == torch.float32:
            return x @ w
        if x.is_cuda:
            out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
            return out.view(*x.shape[:-1], w.shape[-1])
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).T @ grad.reshape(-1, grad.shape[-1])
        return grad @ w.T, gw


def _row_parallel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mesh, axis: str):
    """A row-parallel dense: this rank's partial product in f32 (x and w in
    x's dtype), summed over the model axis in f32, cast, then the bias."""
    dt = x.dtype
    part = _PartialProduct.apply(x, w.to(dt))
    return comm.reduce_from_model(part, mesh, axis).to(dt) + b.to(dt)


# A table with at most this many rows (the token types) takes its gradient
# as one masked sum per row in _ReplicatedEmbedding's backward.
SMALL_TABLE_ROWS = 16


class _ReplicatedEmbedding(torch.autograd.Function):
    """``F.embedding`` whose table gradient has the same bits on every run.
    Under tensor parallelism each model rank holds the embedding tables
    replicated and sees the same ids, so identical gradients keep the
    replicas identical with no collective. CUDA's own embedding backward
    sums repeated ids in a run-dependent order above 3,072 indices
    (PERF.md). Here a small table sums each row's gradient with a masked
    reduction. A larger one accumulates, on the GPU, through ``index_put_``,
    whose CUDA kernel sorts the ids stably and sums each id's rows in that
    order, and on the CPU through ``index_add_``, which adds the rows one
    after another (the CPU's ``index_put_`` and CUDA's ``index_add_`` run
    in a varying order)."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        ids, grad = ids.reshape(-1), grad.reshape(-1, grad.shape[-1])
        if ctx.rows <= SMALL_TABLE_ROWS:
            table = torch.stack([torch.where((ids == r)[:, None], grad, 0.0).sum(0)
                                 for r in range(ctx.rows)])
        elif grad.is_cuda:
            table = grad.new_zeros(ctx.rows, grad.shape[-1]).index_put_(
                (ids,), grad, accumulate=True)
        else:
            table = grad.new_zeros(ctx.rows, grad.shape[-1]).index_add_(0, ids, grad)
        return None, table


def _encoder_layer_tp(x, mask_bias, lp, *, num_heads: int, eps: float, mesh, axis: str):
    """The tensor-parallel layer on this rank's shards (lp's q/k/v/ffn_in
    columns, o/ffn_out rows); x, the layer norms and the output replicated."""
    xc = comm.copy_to_model(x, mesh, axis)
    q = _dense(xc, lp["q_w"], lp["q_b"])
    k = _dense(xc, lp["k_w"], lp["k_b"])
    v = _dense(xc, lp["v_w"], lp["v_b"])
    attn = flash_attention_tp(q, k, v, mask_bias, num_heads=num_heads, mesh=mesh,
                              model_axis=axis, head_dim=x.shape[-1] // num_heads)
    attn = _row_parallel(attn, lp["o_w"], lp["o_b"], mesh, axis)
    x = _layer_norm(x + attn, lp["attn_ln_scale"], lp["attn_ln_bias"], eps)
    h = F.gelu(_dense(comm.copy_to_model(x, mesh, axis), lp["ffn_in_w"], lp["ffn_in_b"]))
    h = _row_parallel(h, lp["ffn_out_w"], lp["ffn_out_b"], mesh, axis)
    return _layer_norm(x + h, lp["ffn_ln_scale"], lp["ffn_ln_bias"], eps)


def _tp_mesh(tp):
    """(mesh, model axis) when ``tp`` shards the model axis, else None."""
    if tp is None:
        return None
    mesh, axis = tp if isinstance(tp, tuple) else (tp, "model")
    return (mesh, axis) if comm.axis_size(mesh, axis) > 1 else None


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
    tp=None,
) -> torch.Tensor:
    """Full encoder stack -> last hidden states [B, S, H] in compute_dtype.
    ``tp``: the mesh (or (mesh, model axis)) whose model axis shards
    ``params``; None or a model axis of 1 runs the single-device layer."""
    emb = params["embeddings"]
    b, s = input_ids.shape
    input_ids = input_ids.long()
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    sharded = _tp_mesh(tp)
    # F.embedding rather than indexing: on the H100 the backward of indexing
    # (indexing_backward_kernel) took 45 of a 309 ms contrastive step (PERF.md)
    embed = _ReplicatedEmbedding.apply if sharded else lambda ids, t: F.embedding(ids, t)
    x = (embed(input_ids, emb["word"])
         + emb["position"][:s][None, :, :]
         + embed(token_type_ids.long(), emb["token_type"]))
    x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], config.layer_norm_eps)
    x = x.to(compute_dtype)

    mask_bias = torch.where(attention_mask > 0, 0.0, NEG_INF).to(torch.float32)  # [B, S]
    layers = params["layers"]
    for i in range(layers["q_w"].shape[0]):
        lp = {name: leaf[i] for name, leaf in layers.items()}
        if sharded:
            x = _encoder_layer_tp(x, mask_bias, lp, num_heads=config.num_heads,
                                  eps=config.layer_norm_eps, mesh=sharded[0], axis=sharded[1])
        else:
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
    tp=None,
) -> torch.Tensor:
    """Sentence-embedding forward: encoder stack -> pool -> L2 norm. [B, H] f32."""
    hidden = bert_forward(params, input_ids, attention_mask, token_type_ids,
                          config=config, compute_dtype=compute_dtype, tp=tp)
    return pool_hidden(hidden, attention_mask, pooling, fused_pool=fused_pool)


def cross_encoder_forward(
    params: BertParams,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: torch.Tensor,
    *,
    config: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
    tp=None,
) -> torch.Tensor:
    """Sequence-classification forward (relevance logits [B]): encoder ->
    pooler (dense+tanh on CLS) -> classifier, as BertForSequenceClassification.
    ``tp`` reaches bert_forward; the JAX function takes no mesh, so its
    rerank step crashes under ``pallas_tp`` (ROADMAP.md §C)."""
    hidden = bert_forward(params, input_ids, attention_mask, token_type_ids,
                          config=config, compute_dtype=compute_dtype, tp=tp)
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
