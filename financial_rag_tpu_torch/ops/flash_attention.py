"""K2: fused bidirectional multi-head self-attention, forward.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors and
runs :func:`flash_attention_plain` for CPU tensors. Counterpart of the
forward of financial_rag_tpu/ops/flash_attention.py; the backward and the
tensor-parallel wrapper are later slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import torch

from financial_rag_tpu_torch.ops import kernel_lib

LAUNCHES = 0
KERNEL_HEAD_DIM = 32  # the only head width the CUDA kernel is built for


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_bias: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """[B,S,H] q/k/v (heads interleaved along H) + additive key bias with
    B*S elements -> [B,S,H] in q.dtype. Scores and softmax in f32; P is cast
    to v.dtype before P@V, as the TPU kernel does."""
    b, s, h = q.shape
    d = h // num_heads
    bias = mask_bias.reshape(b, 1, 1, s).float()

    def split(x):
        return x.reshape(b, s, num_heads, d).transpose(1, 2).float()  # [B,N,S,D]

    scores = split(q) @ split(k).transpose(-1, -2) * (1.0 / (d ** 0.5)) + bias
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).float() @ split(v)
    return o.transpose(1, 2).reshape(b, s, h).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_bias: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """Fused multi-head self-attention. Returns [B, S, H] in q.dtype. The
    CUDA kernel takes bf16 at head_dim 32."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask_bias, num_heads=num_heads)
    global LAUNCHES
    b, s, h = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B,S,H] shape")
    if h != num_heads * KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {KERNEL_HEAD_DIM}, "
                         f"got H={h} over {num_heads} heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bfloat16, {name} is {t.dtype}")
    bias = mask_bias.reshape(b, s).to(torch.float32).contiguous()
    dev = kernel_lib.require_cuda(q, k, v, bias)
    kernel_lib.require_contiguous("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    kernel_lib.launch("flash_attention", "frag_flash_attention", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(k), kernel_lib.ptr(v),
                      kernel_lib.ptr(bias), kernel_lib.ptr(out), b, s, h, num_heads)
    LAUNCHES += 1
    return out
