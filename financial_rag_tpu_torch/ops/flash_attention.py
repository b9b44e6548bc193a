"""K2, K10 and K11: fused bidirectional multi-head self-attention, its
backward, and the tensor-parallel wrapper.

``flash_attention`` is the :class:`FlashAttention` autograd Function. Its
forward launches K2 (``csrc/flash_attention.cu``) for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors. Like the JAX package's custom
VJP it saves only q, k, v and the bias, and its backward recomputes the
probabilities: :func:`flash_attention_bwd` launches K10
(``csrc/flash_attention_bwd.cu``) for CUDA tensors and runs
:func:`flash_attention_bwd_plain` for CPU tensors. Counterpart of
financial_rag_tpu/ops/flash_attention.py.

:func:`flash_attention_tp` (K11) is the counterpart of the JAX
``flash_attention_tp``, which ``shard_map``s the same Pallas kernel over the
model axis so that each device runs its ``num_heads // tp`` local heads. In
the port each rank is a process and its q, k and v already hold only its
heads (the column-parallel projections of models/bert.py make them), so
K11 is :class:`FlashAttention` (K2 forward, K10 backward) at the local head
count, with no collective. It counts its own launches in ``TP_LAUNCHES``
and ``TP_BWD_LAUNCHES``, beside K2's and K10's.
"""

from __future__ import annotations

import torch

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import LAUNCH_LOCK

LAUNCHES = 0        # K2, the forward
BWD_LAUNCHES = 0    # K10, the backward
TP_LAUNCHES = 0     # K11's forward (each also counts in LAUNCHES)
TP_BWD_LAUNCHES = 0  # K11's backward (each also counts in BWD_LAUNCHES)
FWD_HEAD_DIMS = (32, 64)  # the head widths K2 (the forward) is built for
BWD_HEAD_DIMS = (32, 64)  # the head widths K10 (the backward) is built for
FWD_WIDE_KEYS = 64        # keys a K/V tile of K2's head_dim-64 kernel (csrc Wide::kKeys)
FUSED_BWD_MAX_S = 128     # the longest row K10's fused head_dim-64 kernel takes


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B,S,H] (heads interleaved along H) -> [B,N,S,D] float32."""
    b, s, h = x.shape
    return x.reshape(b, s, num_heads, h // num_heads).transpose(1, 2).float()


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d).to(dtype)


def _probabilities(q, k, mask_bias, num_heads: int) -> torch.Tensor:
    """softmax(q k^T * scale + bias) in f32, [B,N,S,S]."""
    b, s, h = q.shape
    scale = 1.0 / ((h // num_heads) ** 0.5)
    scores = (_split(q, num_heads) @ _split(k, num_heads).transpose(-1, -2) * scale
              + mask_bias.reshape(b, 1, 1, s).float())
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_bias: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """[B,S,H] q/k/v (heads interleaved along H) + additive key bias with
    B*S elements -> [B,S,H] in q.dtype. Scores and softmax in f32; P is cast
    to v.dtype before P@V, as the TPU kernel does."""
    p = _probabilities(q, k, mask_bias, num_heads)
    return _merge(p.to(v.dtype).float() @ _split(v, num_heads), q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask_bias: torch.Tensor, dout: torch.Tensor, *,
                              num_heads: int):
    """(dq, dk, dv), each [B,S,H] in q.dtype, with the TPU kernel's rounding
    points (_attn_bwd_kernel): P, dP and dS in f32; P^T and dS cast to q's
    dtype before the products that take them; f32 accumulation."""
    dt = q.dtype
    scale = 1.0 / ((q.shape[-1] // num_heads) ** 0.5)
    p = _probabilities(q, k, mask_bias, num_heads)
    do = _split(dout.to(dt), num_heads)
    dv = p.transpose(-1, -2).to(dt).float() @ do
    dp = do @ _split(v, num_heads).transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = ds.to(dt).float() @ _split(k, num_heads) * scale
    dk = ds.transpose(-1, -2).to(dt).float() @ _split(q, num_heads) * scale
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


def fwd_kernel(s: int, head_dim: int) -> str:
    """The kernel K2 launches for rows of S keys at ``head_dim``, by its
    name in csrc/flash_attention.cu: ``attn_fwd_d64_kernel`` (TMA,
    FWD_WIDE_KEYS-key tiles) at head_dim 64 above S = 64, else
    ``attn_fwd_kernel``."""
    return "attn_fwd_d64_kernel" if head_dim == 64 and s > 64 else "attn_fwd_kernel"


def fwd_block(s: int, head_dim: int):
    """(consumer warpgroups, dynamic shared-memory bytes) of a K2 block, as
    csrc/flash_attention.cu sizes it: one warpgroup of 64 query rows at
    S <= 64, else two; 1 KB of alignment. ``attn_fwd_kernel`` (Block):
    each warpgroup's Q tile and a ring of 4 K + V stages, 64 rows of one
    head's 2 * head_dim bytes each. ``attn_fwd_d64_kernel`` (Wide, two
    persistent blocks an SM), all rows of 128 bytes: two buffers of an
    item's 128 Q rows, 3 stages of a K and a V tile of FWD_WIDE_KEYS rows,
    and the two warpgroups' 64-row O staging tiles."""
    consumers = 1 if s <= 64 else 2
    if fwd_kernel(s, head_dim) == "attn_fwd_d64_kernel":
        return consumers, (2 * 128 + 3 * 2 * FWD_WIDE_KEYS + 128) * 128 + 1024
    return consumers, (consumers + 2 * 4) * 64 * 2 * head_dim + 1024


def bwd_smem_bytes(head_dim: int) -> int:
    """Dynamic shared-memory bytes of a block of K10's two kernels, as
    csrc/flash_attention_bwd.cu's Layout sizes it: two resident 64-row
    tiles of one head's 2 * head_dim bytes a row, a ring of 3 stages of two
    such tiles and a query tile's 2 x 64 f32 statistics, and 1 KB of
    alignment."""
    tile = 64 * 2 * head_dim
    return 2 * tile + 3 * (2 * tile + 2 * 64 * 4) + 1024


def bwd_launch_plan(s: int, head_dim: int):
    """(path, kernels, dynamic shared-memory bytes a block) of K10 for rows
    of S keys, as csrc/flash_attention_bwd.cu picks it from S and the head
    width. ``fused`` (head_dim 64, S <= FUSED_BWD_MAX_S): one kernel, a
    block a (batch row, head) at a time; two buffers of Q, K, V and dO, two
    64-row tiles each, the P and dS tiles of two query by two key tiles and
    dq's two staging tiles, all rows of 2 * head_dim bytes, and 1 KB of
    alignment; no scratch. ``two kernels`` otherwise: the dQ kernel, then
    the dK/dV kernel, joined by the scratch of :func:`bwd_scratch_shape`."""
    if head_dim == 64 and s <= FUSED_BWD_MAX_S:
        tile = 64 * 2 * head_dim
        smem = 2 * 4 * 2 * tile + 2 * 4 * tile + 2 * tile + 1024
        return "fused", ("attn_bwd_fused_d64_kernel",), smem
    return "two kernels", ("attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel"), bwd_smem_bytes(head_dim)


def bwd_scratch_shape(b: int, s: int, num_heads: int) -> tuple:
    """The f32 scratch between K10's two kernels: each query row's
    log-sum-exp (base 2, relative to its batch row's largest key bias) and
    D = rowsum(dP o P)."""
    return (2, b, num_heads, s)


def _kernel_inputs(name: str, kernel: str, head_dims: tuple, q, k, v, mask_bias,
                   num_heads: int, *extra):
    """Checks what the kernels take; returns (the [B,S] f32 bias, device)."""
    b, s, h = q.shape
    if k.shape != q.shape or v.shape != q.shape or any(t.shape != q.shape for t in extra):
        raise ValueError(f"{name}: q, k, v (and dout) must share one [B,S,H] shape")
    if h % num_heads or h // num_heads not in head_dims:
        raise ValueError(f"{name}: the CUDA kernel ({kernel}) takes head_dim "
                         f"{' or '.join(map(str, head_dims))}, got H={h} over {num_heads} heads")
    for i, t in enumerate((q, k, v, *extra)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16, input {i} is {t.dtype}")
    bias = mask_bias.reshape(b, s).to(torch.float32).contiguous()
    dev = kernel_lib.require_cuda(q, k, v, bias, *extra)
    kernel_lib.require_contiguous(name, q, k, v, *extra)
    if any(t.data_ptr() % 16 for t in (q, k, v, *extra)):
        raise ValueError(f"{name} kernel needs 16-byte aligned inputs")
    return bias, dev


def _forward(q, k, v, mask_bias, num_heads: int, tp: bool = False) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask_bias, num_heads=num_heads)
    global LAUNCHES, TP_LAUNCHES
    b, s, h = q.shape
    bias, dev = _kernel_inputs("flash_attention", "K2", FWD_HEAD_DIMS, q, k, v, mask_bias,
                                num_heads)
    out = torch.empty_like(q)
    kernel_lib.launch("flash_attention", "frag_flash_attention", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(k), kernel_lib.ptr(v),
                      kernel_lib.ptr(bias), kernel_lib.ptr(out), b, s, h, num_heads)
    with LAUNCH_LOCK:
        LAUNCHES += 1
        TP_LAUNCHES += tp
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_bias: torch.Tensor, dout: torch.Tensor, *,
                        num_heads: int, tp: bool = False):
    """(dq, dk, dv) of :func:`flash_attention` at dout, each [B,S,H] in
    q.dtype. The CUDA kernel (K10) takes bf16 at head_dim 32 or 64. ``tp``: the
    launch is K11's backward and counts in TP_BWD_LAUNCHES too."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask_bias, dout, num_heads=num_heads)
    global BWD_LAUNCHES, TP_BWD_LAUNCHES
    kernel_lib.require_no_grad("flash_attention_bwd", q, k, v, dout)
    b, s, h = q.shape
    dout = dout.to(q.dtype).contiguous()
    bias, dev = _kernel_inputs("flash_attention_bwd", "K10", BWD_HEAD_DIMS, q, k, v, mask_bias,
                                num_heads, dout)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = None   # the fused kernel needs no scratch
    if bwd_launch_plan(s, h // num_heads)[0] == "two kernels":
        stats = torch.empty(bwd_scratch_shape(b, s, num_heads), dtype=torch.float32, device=dev)
    kernel_lib.launch("flash_attention_bwd", "frag_flash_attention_bwd", dev,
                      *(kernel_lib.ptr(t) for t in (q, k, v, bias, dout, dq, dk, dv)),
                      None if stats is None else kernel_lib.ptr(stats), b, s, h, num_heads)
    with LAUNCH_LOCK:
        BWD_LAUNCHES += 1
        TP_BWD_LAUNCHES += tp
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 forward, K10 backward (the plain versions for CPU tensors). Saves
    q, k, v and the bias only, as the JAX custom VJP does; the bias is the
    padding mask made from the input ids and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask_bias, num_heads: int, tp: bool = False):
        ctx.save_for_backward(q, k, v, mask_bias)
        ctx.num_heads, ctx.tp = num_heads, tp
        return _forward(q, k, v, mask_bias, num_heads, tp)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask_bias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask_bias, dout, num_heads=ctx.num_heads,
                                         tp=ctx.tp)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_bias: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """Fused multi-head self-attention. Returns [B, S, H] in q.dtype.
    Differentiable in q, k and v. The CUDA kernels take bf16: the forward
    (K2) and the backward (K10) at head_dim 32 or 64."""
    return FlashAttention.apply(q, k, v, mask_bias, num_heads)


def flash_attention_tp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask_bias: torch.Tensor, *, num_heads: int, mesh,
                       model_axis: str = "model",
                       head_dim: int = 32) -> torch.Tensor:
    """K11: attention under tensor parallelism. q, k, v are this rank's
    [B_local, S, (num_heads // tp) * head_dim] slices (its heads, in head
    order), mask_bias the [B_local, S] key bias of its rows; returns the
    local [B_local, S, H/tp] output. ``num_heads`` is the model's head
    count; only ``mesh.shape[model_axis]`` is read from the mesh.
    Differentiable in q, k and v (K10 at the local heads)."""
    tp = mesh.shape[model_axis]
    if num_heads % tp != 0:
        raise ValueError(f"num_heads={num_heads} not divisible by tp={tp}")
    local = num_heads // tp
    if q.shape[-1] != local * head_dim:
        raise ValueError(f"flash_attention_tp takes this rank's {local} heads of {head_dim} "
                         f"(width {local * head_dim}), got width {q.shape[-1]}")
    return FlashAttention.apply(q, k, v, mask_bias, local, True)
