"""K9: causal grouped-query self-attention forward for decoder prefill.

``causal_flash_prefill`` launches ``csrc/causal_flash.cu`` for CUDA tensors
and runs :func:`causal_flash_prefill_plain` for CPU tensors. Counterpart of
financial_rag_tpu/ops/causal_flash.py, in its layout: q ``[B,S,Hq*D]``, k and
v ``[B,S,Hkv*D]`` with the heads interleaved along the last axis, and a
per-row left-pad length instead of a mask tensor (the serving prompts are
contiguously left-padded).

The kernels are built for heads of 64 and 128 (``KERNEL_HEAD_DIMS``). A
narrower head (open_llama_3b's 100, 80, 96) is read where it lies at the
widths :func:`causal_reads_in_place` names: at the head-128 kernel (in f32
at either), its other columns zeros (the TMA's past a head of whole
16-byte chunks, or zeroed in shared memory in a 16-byte aligned window),
the scores scaled by its true head_dim, the products only as wide as the
head's columns, and only its own columns of the output written. At any
other width (an odd head_dim, a bf16 head below 64) the wrapper zero-pads
each head to the built
width in a copy (``ops.common.pad_heads``) and tells the kernel the true
head_dim; the output's padded columns come out zero and are dropped. Heads
wider than 128 are refused.
"""

from __future__ import annotations

from collections import Counter

import torch

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import LAUNCH_LOCK, built_head_dim, pad_heads, unpad_heads

LAUNCHES = 0
HEAD_DIM_LAUNCHES: Counter = Counter()  # launches by true head_dim (each also counts in LAUNCHES)
IN_PLACE_LAUNCHES: Counter = Counter()  # of those, the ones that read the heads where they lie
KERNEL_HEAD_DIMS = (64, 128)  # the head widths the CUDA kernel is built for


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


def causal_reads_in_place(head_dim: int, num_q_heads: int, num_kv_heads: int,
                          dtype: torch.dtype) -> bool:
    """Whether K9 reads heads of ``head_dim`` (<= 128) where they lie, with
    no padded copy, as the C entry checks it (``reads_in_place`` in
    csrc/causal_flash.cu): any even head_dim in f32 (8-byte pairs). In
    bf16, 64 (the head-64 kernel takes only whole heads: its producer warp
    issues every K/V copy, and column-predicated copies there ran 1.8x
    slower), and above 64 at the head-128 kernel a multiple of 8 (whole
    16-byte chunks through 4-D tensor maps) or an even head_dim read as a
    16-byte aligned window of 128 columns from its first column rounded
    down to a multiple of 8: where the window fits (at most 8 - head_dim's
    lowest set bit columns before the head: 100, 98, 102), over rows of
    whole 16-byte chunks (kv heads x head_dim a multiple of 8: the window's
    3-D map takes no other row stride), and with one kv head a query head
    (a query head's window offset is then its kv head's, so Q's columns
    meet K's). The rest, odd widths among them, is padded in a copy."""
    if head_dim % 2 or head_dim > KERNEL_HEAD_DIMS[-1]:
        return False
    if dtype != torch.bfloat16:
        return True
    if head_dim <= KERNEL_HEAD_DIMS[0]:
        return head_dim == KERNEL_HEAD_DIMS[0]
    return head_dim % 8 == 0 or (head_dim + 8 - (head_dim & -head_dim) <= KERNEL_HEAD_DIMS[-1]
                                 and num_q_heads == num_kv_heads
                                 and num_kv_heads * head_dim % 8 == 0)


def causal_flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pad_len: torch.Tensor, *, num_q_heads: int,
                         num_kv_heads: int) -> torch.Tensor:
    """Causal, left-padded GQA attention. Returns [B, S, Hq*D] in q.dtype.

    Rows inside the left padding (position < pad_len) are written as zeros
    by both the kernel and the plain version; no caller reads them. The
    CUDA kernel takes bf16 or f32 (all three of q, k, v alike) at head_dim
    up to 128 (narrower heads read in place, or zero-padded to 64 or 128 in
    a copy where :func:`causal_reads_in_place` says no); ``pad_len`` stays
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
    in_place = causal_reads_in_place(d, num_q_heads, num_kv_heads, q.dtype)
    if not in_place:
        q = pad_heads(q, num_q_heads, width)
        k, v = (pad_heads(t, num_kv_heads, width) for t in (k, v))
    out = torch.empty_like(q)
    kernel_lib.launch("causal_flash_prefill", "frag_causal_flash", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(k), kernel_lib.ptr(v),
                      kernel_lib.ptr(pad), kernel_lib.ptr(out),
                      b, s, num_q_heads, num_kv_heads, d if in_place else width, code, d)
    with LAUNCH_LOCK:
        LAUNCHES += 1
        HEAD_DIM_LAUNCHES[d] += 1
        IN_PLACE_LAUNCHES[d] += in_place
    return out if in_place else unpad_heads(out, num_q_heads, d)
