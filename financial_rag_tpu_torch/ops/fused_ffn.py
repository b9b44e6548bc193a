"""K3: fused BERT feed-forward, gelu(x @ W1 + b1) @ W2 + b2, and its backward.

``fused_ffn`` is the :class:`FusedFFN` autograd Function. Its forward
launches ``csrc/fused_ffn.cu`` for CUDA tensors and runs
:func:`fused_ffn_plain` for CPU tensors; its backward is
:func:`fused_ffn_bwd`, the JAX package's rematerialising backward
(financial_rag_tpu/ops/fused_ffn.py ``_core_bwd``, XLA there, so plain
f32 matmuls here): it recomputes the intermediate from the saved x instead
of keeping it. One deliberate difference from the JAX package: GELU is the
exact erf form (the checkpoints', HF's and the JAX package's own XLA path),
in the forward and in its derivative, where the TPU kernel used the tanh
form only because Mosaic has no erf.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import LAUNCH_LOCK, round_up

LAUNCHES = 0
WIDTH_LAUNCHES: Counter = Counter()  # launches by hidden width (each also counts in LAUNCHES)
KERNEL_HIDDEN = 384    # the hidden width of the first design (bge-small, gte-small, MiniLM)
KERNEL_TOKENS = 128    # its tokens per block; the kernel zero-fills the ragged last tile
KERNEL_CHUNK = 32      # its I chunk: the intermediate width must be a multiple
KERNEL_MIN_CHUNKS = 4  # I chunks a block walks at least when the I axis is split
KERNEL_STAGES = 2      # its ring: 2 stages of one chunk of W1 and of W2
WIDE_HIDDEN = 768      # the hidden width of the second design (bge-base, gte-base)
WIDE_TOKENS = 64       # its tokens per block (both warpgroups on the same rows)
WIDE_CHUNK = 64        # its I chunk: 32 columns of h a warpgroup
WIDE_MIN_CHUNKS = 2    # I chunks a split block walks at least
WIDE_H_TILES = 2       # its h tiles (64 x 64 bf16): even and odd chunks
WIDE_SLAB_BYTES = 24576  # one stage of its ring: 192 rows of W1's chunk or 16 of W2's
WIDE_STAGES = 4
LARGE_HIDDEN = 1024    # the third design (bge-large, gte-large): the second's block and
LARGE_PASSES = 2       # chunks, y in two passes of 512 columns over the whole I axis
LARGE_SLAB_BYTES = 16384  # one stage of its ring: 128 rows of W1's chunk or 16 of W2's 512 columns
LARGE_STAGES = 5
# hidden width -> (tokens a block, I chunk, fewest chunks a split block walks)
KERNEL_TILING = {KERNEL_HIDDEN: (KERNEL_TOKENS, KERNEL_CHUNK, KERNEL_MIN_CHUNKS),
                 WIDE_HIDDEN: (WIDE_TOKENS, WIDE_CHUNK, WIDE_MIN_CHUNKS),
                 LARGE_HIDDEN: (WIDE_TOKENS, WIDE_CHUNK, WIDE_MIN_CHUNKS)}
# the designs of 64 tokens a block: hidden -> (y passes, ring slab bytes, stages)
WIDE_RING = {WIDE_HIDDEN: (1, WIDE_SLAB_BYTES, WIDE_STAGES),
             LARGE_HIDDEN: (LARGE_PASSES, LARGE_SLAB_BYTES, LARGE_STAGES)}


def kernel_takes(h_dim: int, i_dim: int) -> bool:
    """Whether the CUDA kernel is built for hidden ``h_dim`` with
    intermediate ``i_dim`` (a whole number of that design's chunks)."""
    return h_dim in KERNEL_TILING and i_dim > 0 and i_dim % KERNEL_TILING[h_dim][1] == 0


def split_count(tiles: int, chunks: int, sms: int, min_chunks: int = KERNEL_MIN_CHUNKS) -> int:
    """How many blocks share one token tile's I axis at hidden 384: the
    fewest (a divisor of the chunk count) that give every SM a block (the
    kernel's shared memory fits one block per SM), but no more than leave
    each block ``min_chunks`` chunks: each split writes and reads back an
    f32 partial of the tile, which at a query's few tiles costs more than
    the chunks it saves. Ingest-sized calls get 1 (no partials); a query's
    4 tiles of 128 tokens get 12 splits of 4 of the 48 chunks."""
    best = 1
    for d in range(1, chunks // min_chunks + 1):
        if chunks % d == 0:
            best = d
            if tiles * d >= sms:
                break
    return best


def wide_split_count(tiles: int, chunks: int, sms: int, min_chunks: int = WIDE_MIN_CHUNKS) -> int:
    """How many blocks share one token tile's I axis at hidden 768 or 1,024: the
    most (a divisor of the chunk count, each block walking at least
    ``min_chunks``) that still fit the grid on the SMs in one wave (a
    block holds an SM), so the f32 partials are written once, by blocks
    that all run at once; 1 from one tile an SM on. A query's 8 tiles get
    16 splits of 3 of the 48 chunks at 768 (128 blocks), of 4 of the 64
    at 1,024."""
    best = 1
    for d in range(1, chunks // min_chunks + 1):
        if chunks % d == 0 and tiles * d <= sms:
            best = d
    return best


def launch_plan(n: int, h_dim: int, i_dim: int, sms: int):
    """K3's launch for n tokens: (tokens a block, I chunk, splits); the
    grid is one block a token tile and split."""
    tokens, chunk, min_chunks = KERNEL_TILING[h_dim]
    tiles = round_up(n, tokens) // tokens
    count = wide_split_count if h_dim in WIDE_RING else split_count
    return tokens, chunk, count(tiles, i_dim // chunk, sms, min_chunks)


def block_smem_bytes(h_dim: int) -> int:
    """Dynamic shared memory of a K3 block, as csrc/fused_ffn.cu sizes it,
    with 1 KB of alignment: at 384 both warpgroups' x rows (bf16) and a
    ring of 2 stages of one I chunk of W1 and of W2; at 768 and 1,024 the
    block's x rows, two h tiles and a ring of 4 stages of a 24 KB slab or
    5 of a 16 KB one."""
    tokens, chunk, _ = KERNEL_TILING[h_dim]
    if h_dim in WIDE_RING:
        _, slab, stages = WIDE_RING[h_dim]
        return tokens * h_dim * 2 + WIDE_H_TILES * tokens * chunk * 2 + stages * slab + 1024
    return tokens * h_dim * 2 + KERNEL_STAGES * (2 * h_dim * chunk * 2) + 1024


def accumulator_registers(h_dim: int) -> int:
    """f32 registers of y a thread of K3 holds: each of the two warpgroups
    (128 threads) owns 64 token rows and, at 768 and 1,024, half of a
    pass's y columns (all of y at 768, 512 columns at 1,024)."""
    tokens, _, _ = KERNEL_TILING[h_dim]
    if h_dim == KERNEL_HIDDEN:
        return (tokens // 2) * h_dim // 128
    passes = WIDE_RING[h_dim][0]
    return tokens * (h_dim // passes // 2) // 128


def h_registers(h_dim: int) -> int:
    """f32 registers of h (one chunk's first product) a thread of K3 holds:
    64 rows by the chunk at 384, by its warpgroup's half of the chunk at
    768 and 1,024."""
    _, chunk, _ = KERNEL_TILING[h_dim]
    cols = chunk if h_dim == KERNEL_HIDDEN else chunk // 2
    return 64 * cols // 128


def fused_ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Same rounding points as the kernel: f32 accumulation and bias add,
    erf GELU in f32, the intermediate cast to x.dtype, f32 second product."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.to(dt).float()
    h = F.gelu(h, approximate="none").to(dt)
    y = h.float() @ w2.to(dt).float() + b2.to(dt).float()
    return y.to(dt)


def fused_ffn_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, dy: torch.Tensor):
    """(dx, dw1, db1, dw2, db2), each in its input's dtype. Recomputes
    h1 = x W1 + b1 once, in f32 from the weights as given (the f32 master
    weights in training), and takes every gradient in f32, as _core_bwd."""
    h_dim = x.shape[-1]
    xf = x.reshape(-1, h_dim).float()
    dyf = dy.reshape(-1, h_dim).float()
    w1f, w2f = w1.float(), w2.float()
    h1 = xf @ w1f + b1.float()
    a = F.gelu(h1, approximate="none")
    dh1 = torch.ops.aten.gelu_backward(dyf @ w2f.T, h1, approximate="none")
    dx = (dh1 @ w1f.T).to(x.dtype).reshape(x.shape)
    return (dx, (xf.T @ dh1).to(w1.dtype), dh1.sum(0).to(b1.dtype),
            (a.T @ dyf).to(w2.dtype), dyf.sum(0).to(b2.dtype))


def _forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1, b1, w2, b2)
    global LAUNCHES
    orig_shape = x.shape
    h_dim = orig_shape[-1]
    i_dim = w1.shape[1]
    if (not kernel_takes(h_dim, i_dim) or w1.shape != (h_dim, i_dim)
            or w2.shape != (i_dim, h_dim) or b1.shape != (i_dim,) or b2.shape != (h_dim,)):
        raise ValueError(f"fused_ffn kernel takes H={KERNEL_HIDDEN} with I a multiple of "
                         f"{KERNEL_CHUNK}, or H={WIDE_HIDDEN} with I a multiple of "
                         f"{WIDE_CHUNK}, or H={LARGE_HIDDEN} with I a multiple of {WIDE_CHUNK}; "
                         f"got x {tuple(orig_shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_ffn kernel takes bfloat16, x is {x.dtype}")
    # the weights in x's dtype: no copy for a bf16 inference tree, one cast
    # per call from the f32 master weights in training
    w1, b1, w2, b2 = (t.to(x.dtype).contiguous() for t in (w1, b1, w2, b2))
    dev = kernel_lib.require_cuda(x, w1, b1, w2, b2)
    kernel_lib.require_contiguous("fused_ffn", x)
    for t in (x, w1, w2):
        if t.data_ptr() % 16:
            raise ValueError("fused_ffn kernel needs 16-byte aligned x, w1 and w2")
    x2d = x.reshape(-1, h_dim)
    n = x2d.shape[0]
    if n == 0:
        return x.new_empty(orig_shape)
    out = torch.empty((n, h_dim), dtype=x.dtype, device=dev)
    _, _, splits = launch_plan(n, h_dim, i_dim,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = (torch.empty((splits, n, h_dim), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    kernel_lib.launch("fused_ffn", "frag_fused_ffn", dev,
                      kernel_lib.ptr(x2d), kernel_lib.ptr(w1), kernel_lib.ptr(b1),
                      kernel_lib.ptr(w2), kernel_lib.ptr(b2), kernel_lib.ptr(out),
                      kernel_lib.ptr(partial) if partial is not None else None,
                      n, h_dim, i_dim, splits)
    with LAUNCH_LOCK:
        LAUNCHES += 1
        WIDTH_LAUNCHES[h_dim] += 1
    return out.reshape(orig_shape)


class FusedFFN(torch.autograd.Function):
    """K3 forward (the plain version for CPU tensors), rematerialising
    backward. Takes the weights as they are kept (f32 masters in training)
    and casts them to x's dtype for the forward only, so the weight
    gradients are computed and returned in f32."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        return fused_ffn_bwd(*ctx.saved_tensors, dy)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [..., H] -> [..., H] in x.dtype, the [.., I] intermediate kept on
    chip. Differentiable in x and the weights. The CUDA kernel takes bf16 x
    at H = 384, 768 or 1,024 (the weights are cast to x's dtype)."""
    return FusedFFN.apply(x, w1, b1, w2, b2)
