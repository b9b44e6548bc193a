"""K1: fused masked mean-pool + L2-normalise (the gte pooling).

``masked_mean_l2_normalize`` launches ``csrc/pool_norm.cu`` for CUDA tensors
and runs :func:`masked_mean_l2_normalize_plain` for CPU tensors. Counterpart
of financial_rag_tpu/ops/pool_norm.py.
"""

from __future__ import annotations

import torch

from financial_rag_tpu_torch.ops import kernel_lib

LAUNCHES = 0


def masked_mean_l2_normalize_plain(hidden: torch.Tensor,
                                   attention_mask: torch.Tensor) -> torch.Tensor:
    """[B,S,H] hidden + [B,S] mask -> [B,H] float32 unit vectors."""
    h = hidden.float()
    m = attention_mask.float()
    summed = (h * m[:, :, None]).sum(dim=1)
    counts = m.sum(dim=1, keepdim=True).clamp_min(1e-9)
    pooled = summed / counts
    inv = torch.rsqrt((pooled * pooled).sum(dim=-1, keepdim=True).clamp_min(1e-24))
    return pooled * inv


def masked_mean_l2_normalize(hidden: torch.Tensor,
                             attention_mask: torch.Tensor) -> torch.Tensor:
    """Returns [B, H] float32 unit vectors."""
    if hidden.device.type == "cpu":
        return masked_mean_l2_normalize_plain(hidden, attention_mask)
    global LAUNCHES
    kernel_lib.require_no_grad("masked_mean_l2_normalize", hidden, attention_mask)
    b, s, h = hidden.shape
    if attention_mask.shape != (b, s):
        raise ValueError(f"mask shape {tuple(attention_mask.shape)} != {(b, s)}")
    if h % 8:
        raise ValueError(f"masked_mean_l2_normalize: H={h} must be a multiple of 8 "
                         "(the kernel loads 16 bytes of a token at a time)")
    mask = attention_mask.to(torch.float32).contiguous()
    dev = kernel_lib.require_cuda(hidden, mask)
    kernel_lib.require_contiguous("masked_mean_l2_normalize", hidden)
    kernel_lib.require_aligned("masked_mean_l2_normalize", hidden)
    code = kernel_lib.dtype_code("masked_mean_l2_normalize", hidden.dtype)
    out = torch.empty((b, h), dtype=torch.float32, device=dev)
    kernel_lib.launch("masked_mean_l2_normalize", "frag_pool_norm", dev,
                      kernel_lib.ptr(hidden), kernel_lib.ptr(mask), kernel_lib.ptr(out),
                      b, s, h, code)
    LAUNCHES += 1
    return out
