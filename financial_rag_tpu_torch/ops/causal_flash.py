"""K9: causal grouped-query self-attention forward for decoder prefill.

``causal_flash_prefill`` launches ``csrc/causal_flash.cu`` for CUDA tensors
and runs :func:`causal_flash_prefill_plain` for CPU tensors. Counterpart of
financial_rag_tpu/ops/causal_flash.py, in its layout: q ``[B,S,Hq*D]``, k and
v ``[B,S,Hkv*D]`` with the heads interleaved along the last axis, and a
per-row left-pad length instead of a mask tensor (the serving prompts are
contiguously left-padded).

The kernels are built for heads of 64 and 128 (``KERNEL_HEAD_DIMS``). A
narrower head (open_llama_3b's 100, 80, 96) is zero-padded to the next built
width in a copy made by the wrapper, and the kernel is told the true
head_dim, whose 1 / sqrt scales the scores; the output's padded columns
come out zero and are dropped. Heads wider than 128 are refused.
"""

from __future__ import annotations

from collections import Counter

import torch

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import LAUNCH_LOCK, built_head_dim, pad_heads, unpad_heads

LAUNCHES = 0
HEAD_DIM_LAUNCHES: Counter = Counter()  # launches by true head_dim (each also counts in LAUNCHES)
KERNEL_HEAD_DIMS = (64, 128)  # the head widths the CUDA kernel is built for; narrower heads are padded


def causal_flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               pad_len: torch.Tensor, *, num_q_heads: int,
                               num_kv_heads: int) -> torch.Tensor:
    """Query position i attends key j iff pad_len <= j <= i. Scores and
    softmax in f32; the unnormalised P is cast to v.dtype before P@V, as the
    TPU kernel does. Rows with i < pad_len come out as zeros."""
    b, s, hq = q.shape
    d = hq // num_q_heads
    g = num_q_heads // num_kv_heads
    qh = q.reshape(b, s, num_kv_heads, g, d).float()
    kh = k.reshape(b, s, num_kv_heads, d).float()
    vh = v.reshape(b, s, num_kv_heads, d).permute(0, 2, 1, 3)[:, :, None]   # [B,KV,1,T,D]
    scores = torch.einsum("bskgd,btkd->bkgst", qh, kh) * (1.0 / d ** 0.5)
    pos = torch.arange(s, device=q.device)
    pad = pad_len.to(device=q.device, dtype=torch.long).view(b, 1, 1)
    allow = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] >= pad)  # [B,S,T]
    scores = scores.masked_fill(~allow[:, None, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).float() @ vh.float()                                   # [B,KV,G,S,D]
    o = torch.where(l > 0, o / l.clamp_min(1e-30), torch.zeros_like(o))
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq).to(q.dtype)


def causal_flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pad_len: torch.Tensor, *, num_q_heads: int,
                         num_kv_heads: int) -> torch.Tensor:
    """Causal, left-padded GQA attention. Returns [B, S, Hq*D] in q.dtype.

    Rows inside the left padding (position < pad_len) are written as zeros
    by both the kernel and the plain version; no caller reads them. The
    CUDA kernel takes bf16 or f32 (all three of q, k, v alike) at head_dim
    up to 128 (narrower heads zero-padded to 64 or 128); ``pad_len`` stays
    on the device (no host sync).
    """
    if q.device.type == "cpu":
        return causal_flash_prefill_plain(q, k, v, pad_len, num_q_heads=num_q_heads,
                                          num_kv_heads=num_kv_heads)
    global LAUNCHES
    kernel_lib.require_no_grad("causal_flash_prefill", q, k, v)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("causal_flash_prefill takes q [B,S,Hq*D] and k, v [B,S,Hkv*D]")
    b, s, hq = q.shape
    if num_kv_heads < 1 or num_q_heads % num_kv_heads or hq % num_q_heads:
        raise ValueError(f"{num_q_heads} query heads over {num_kv_heads} kv heads "
                         f"do not divide width {hq}")
    d = hq // num_q_heads
    width = built_head_dim(d, KERNEL_HEAD_DIMS)
    if width is None:
        raise ValueError(f"the CUDA kernel (K9) takes head_dim <= {KERNEL_HEAD_DIMS[-1]} "
                         f"(zero-padded to {' or '.join(map(str, KERNEL_HEAD_DIMS))}), got {d}")
    if k.shape != (b, s, num_kv_heads * d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B,S,Hkv*D] = {(b, s, num_kv_heads * d)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("causal_flash_prefill: q, k and v must share one dtype")
    code = kernel_lib.dtype_code("causal_flash_prefill", q.dtype)
    if pad_len.shape != (b,):
        raise ValueError(f"pad_len must be [B] = [{b}], got {tuple(pad_len.shape)}")
    pad = pad_len.to(torch.int32).contiguous()
    dev = kernel_lib.require_cuda(q, k, v, pad)
    kernel_lib.require_contiguous("causal_flash_prefill", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("causal_flash_prefill kernel needs 16-byte aligned q, k and v")
    q = pad_heads(q, num_q_heads, width)
    k, v = (pad_heads(t, num_kv_heads, width) for t in (k, v))
    out = torch.empty_like(q)
    kernel_lib.launch("causal_flash_prefill", "frag_causal_flash", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(k), kernel_lib.ptr(v),
                      kernel_lib.ptr(pad), kernel_lib.ptr(out),
                      b, s, num_q_heads, num_kv_heads, width, code, d)
    with LAUNCH_LOCK:
        LAUNCHES += 1
        HEAD_DIM_LAUNCHES[d] += 1
    return unpad_heads(out, num_q_heads, d)
