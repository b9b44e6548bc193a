"""K3: fused BERT feed-forward, forward: gelu(x @ W1 + b1) @ W2 + b2.

``fused_ffn`` launches ``csrc/fused_ffn.cu`` for CUDA tensors and runs
:func:`fused_ffn_plain` for CPU tensors. Counterpart of the forward of
financial_rag_tpu/ops/fused_ffn.py, with one deliberate difference: GELU is
the exact erf form (the checkpoints', HF's and the JAX package's own XLA
path), where the TPU kernel used the tanh form only because Mosaic has no
erf. The backward is a later slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import round_up

LAUNCHES = 0
KERNEL_HIDDEN = 384    # the hidden width the CUDA kernel is built for
KERNEL_TOKENS = 64     # tokens per block; N is padded to a multiple
KERNEL_CHUNK = 32      # the intermediate width must be a multiple


def split_count(tiles: int, chunks: int, sms: int) -> int:
    """How many blocks share one token tile's I axis: the fewest (a divisor
    of the chunk count) that give every SM a block (the kernel's shared
    memory fits one block per SM), else one per chunk. Ingest-sized calls
    get 1 (no partials); a query's 8 tiles get 24."""
    for d in range(1, chunks + 1):
        if chunks % d == 0 and tiles * d >= sms:
            return d
    return chunks


def fused_ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Same rounding points as the kernel: f32 accumulation and bias add,
    erf GELU in f32, the intermediate cast to x.dtype, f32 second product."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.to(dt).float()
    h = F.gelu(h, approximate="none").to(dt)
    y = h.float() @ w2.to(dt).float() + b2.to(dt).float()
    return y.to(dt)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [..., H] -> [..., H] in x.dtype, the [.., I] intermediate kept on
    chip. The CUDA kernel takes bf16 at H = 384."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2)
    global LAUNCHES
    orig_shape = x.shape
    h_dim = orig_shape[-1]
    i_dim = w1.shape[1]
    if (h_dim != KERNEL_HIDDEN or w1.shape != (h_dim, i_dim) or w2.shape != (i_dim, h_dim)
            or b1.shape != (i_dim,) or b2.shape != (h_dim,) or i_dim % KERNEL_CHUNK):
        raise ValueError(f"fused_ffn kernel takes H={KERNEL_HIDDEN} and I a multiple of "
                         f"{KERNEL_CHUNK}; got x {tuple(orig_shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_ffn kernel takes bfloat16, {name} is {t.dtype}")
    dev = kernel_lib.require_cuda(x, w1, b1, w2, b2)
    kernel_lib.require_contiguous("fused_ffn", x, w1, b1, w2, b2)
    for t in (x, w1, w2):
        if t.data_ptr() % 16:
            raise ValueError("fused_ffn kernel needs 16-byte aligned x, w1 and w2")
    x2d = x.reshape(-1, h_dim)
    n = x2d.shape[0]
    npad = round_up(max(n, 1), KERNEL_TOKENS)
    if npad != n:
        x2d = F.pad(x2d, (0, 0, 0, npad - n))
    out = torch.empty((npad, h_dim), dtype=x.dtype, device=dev)
    splits = split_count(npad // KERNEL_TOKENS, i_dim // KERNEL_CHUNK,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = (torch.empty((splits, npad, h_dim), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    kernel_lib.launch("fused_ffn", "frag_fused_ffn", dev,
                      kernel_lib.ptr(x2d), kernel_lib.ptr(w1), kernel_lib.ptr(b1),
                      kernel_lib.ptr(w2), kernel_lib.ptr(b2), kernel_lib.ptr(out),
                      kernel_lib.ptr(partial) if partial is not None else None,
                      npad, h_dim, i_dim, splits)
    LAUNCHES += 1
    return out[:n].reshape(orig_shape)
