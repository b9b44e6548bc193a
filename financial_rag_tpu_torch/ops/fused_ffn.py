"""K3: fused BERT feed-forward, gelu(x @ W1 + b1) @ W2 + b2, and its backward.

``fused_ffn`` is the :class:`FusedFFN` autograd Function. Its forward
launches ``csrc/fused_ffn.cu`` for CUDA tensors and runs
:func:`fused_ffn_plain` for CPU tensors. At hidden 384 and 768 one kernel
keeps the [N, I] intermediate h on chip, as the TPU kernel does; at 1,024
(bge-large, gte-large) h goes through device memory between two kernels
with fused epilogues (``frag_fused_ffn_large``), since a register-resident
y does not fit a block there and h's round trip (16 KB a token against
16.8 MFLOP) stays under the products' time. Every other width whose rows
are whole 16-byte chunks (H and I multiples of 8: TinyBERT's 312 / 1,200,
the BERT miniatures' 128 to 512, 2,048) takes the generic route, the same
two products with run-time extents (:func:`kernel_route`). Its backward is
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
from financial_rag_tpu_torch.ops.common import LAUNCH_LOCK, cdiv, round_up

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
LARGE_HIDDEN = 1024    # the third design (bge-large, gte-large): two products through h
LARGE_TOKENS = 128     # token rows of a tile of either product (64 a consumer warpgroup)
LARGE_DEPTH = 64       # k a ring stage holds: the intermediate width must be a multiple
LARGE_WIDE_COLS = 256  # output columns of a wide tile (128 accumulators a thread)
LARGE_NARROW_COLS = 128  # of a narrow one, where wide tiles would leave SMs idle
LARGE_SLIM_COLS = 64   # of a slim one: the generic route's, where its grid still fits one wave
# The generic route's second product at a query's tokens: the cost of a k step
# of a 64-column tile, and of the split's f32 partials and reduce (a fixed
# part and one a split), in k steps of a 128-column tile, as the
# plans' device times at 512 tokens put them (scripts/k3_plans.py)
SLIM_STEP_COST = 0.6
SPLIT_COST = (2.0, 0.5)
LARGE_WIDE_STAGES = 4  # the ring: 4 stages of a 128 x 64 A tile and a 64 x 256 B tile
LARGE_NARROW_STAGES = 6  # or 6 of a 128 x 64 and a 64 x 128 one
LARGE_MIN_STEPS = 4    # k steps a split block of the second product walks at least
LARGE_THREADS = 384    # two consumer warpgroups and a producer warpgroup
LARGE_OUT_COLS = 128   # output columns a consumer warpgroup stages for one TMA store
GENERIC_GRANULE = 8   # the generic route's H and I: rows of whole 16-byte chunks (the TMA's)
# hidden width -> (tokens a block, I granule, fewest granules a split block walks)
KERNEL_TILING = {KERNEL_HIDDEN: (KERNEL_TOKENS, KERNEL_CHUNK, KERNEL_MIN_CHUNKS),
                 WIDE_HIDDEN: (WIDE_TOKENS, WIDE_CHUNK, WIDE_MIN_CHUNKS),
                 LARGE_HIDDEN: (LARGE_TOKENS, LARGE_DEPTH, LARGE_MIN_STEPS)}


def kernel_route(h_dim: int, i_dim: int):
    """The CUDA route of hidden ``h_dim`` with intermediate ``i_dim``:
    ``"fused"`` (``frag_fused_ffn``, h on chip) at 384 and 768 with I a
    whole number of that design's chunks, ``"large"`` (the two products of
    ``frag_fused_ffn_large``) at 1,024 with I a multiple of 64, else
    ``"generic"`` (the same two products at run-time extents) where H and I
    are multiples of GENERIC_GRANULE; None where no route takes them."""
    if h_dim in KERNEL_TILING and i_dim > 0 and i_dim % KERNEL_TILING[h_dim][1] == 0:
        return "large" if h_dim == LARGE_HIDDEN else "fused"
    if h_dim > 0 and i_dim > 0 and h_dim % GENERIC_GRANULE == 0 and i_dim % GENERIC_GRANULE == 0:
        return "generic"
    return None


def kernel_takes(h_dim: int, i_dim: int) -> bool:
    """Whether a CUDA route takes hidden ``h_dim`` with intermediate
    ``i_dim``."""
    return kernel_route(h_dim, i_dim) is not None


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
    """How many blocks share one token tile's I axis at hidden 768: the
    most (a divisor of the chunk count, each block walking at least
    ``min_chunks``) that still fit the grid on the SMs in one wave (a
    block holds an SM), so the f32 partials are written once, by blocks
    that all run at once; 1 from one tile an SM on. A query's 8 tiles get
    16 splits of 3 of the 48 chunks (128 blocks)."""
    best = 1
    for d in range(1, chunks // min_chunks + 1):
        if chunks % d == 0 and tiles * d <= sms:
            best = d
    return best


def launch_plan(n: int, h_dim: int, i_dim: int, sms: int):
    """K3's launch for n tokens: (tokens a block, I chunk, splits); at 384
    and 768 the grid is one block a token tile and split, at 1,024 and on
    the generic route see :func:`large_launch_plan`."""
    if kernel_route(h_dim, i_dim) in ("large", "generic"):
        return LARGE_TOKENS, LARGE_DEPTH, large_launch_plan(n, i_dim, sms, h_dim)[2]
    tokens, chunk, min_chunks = KERNEL_TILING[h_dim]
    tiles = round_up(n, tokens) // tokens
    count = wide_split_count if h_dim == WIDE_HIDDEN else split_count
    return tokens, chunk, count(tiles, i_dim // chunk, sms, min_chunks)


def wide_tiles_fit(cols: int) -> bool:
    """Whether 256-column tiles leave no more columns idle than 128-column
    ones over ``cols`` output columns (1,024, 1,200, 2,048: yes; 128, 312:
    no)."""
    return round_up(cols, LARGE_WIDE_COLS) == round_up(cols, LARGE_NARROW_COLS)


def large_launch_plan(n: int, i_dim: int, sms: int, h_dim: int = LARGE_HIDDEN):
    """(first product's tile columns, second product's, splits) of the two
    products for n tokens at hidden ``h_dim`` (the 1,024 design, or the
    generic route), I = i_dim, on ``sms`` SMs. Each product is a persistent
    grid of one block an SM over tiles of 128 tokens. The first product
    (N x I) takes 256-column tiles unless the 128-column ones still fit one
    wave, as at a query's 4 token tiles (64 tiles of 256 columns, 128 of
    128), or leave fewer columns idle. The second (N x H) takes 256-column
    tiles from one wave of them on, where they leave no more columns idle;
    else 128-column ones, with its K axis (ceil(I / 64) steps) split the
    most ways (each split at least LARGE_MIN_STEPS steps) that keep the
    grid in one wave: f32 partials, summed in split order by the reduce.
    At 1,024 a split divides the steps: 512 tokens (128, 128, 4), 34,816
    (256, 256, 1). The generic route's first product takes 64-column tiles
    where they still fit one wave (a query's tokens), and its second the
    tiles and split of :func:`generic_down_plan`, whose split need not
    divide the steps (split s walks steps s * steps // splits .. (s + 1) *
    steps // splits - 1): at 312 / 1,200 and 512 tokens 76 blocks of the
    first product (not 40) and 80 of the second, each walking 4 or 5 of
    its 19 k steps (not 12 walking all 19)."""
    tiles = cdiv(n, LARGE_TOKENS)
    generic = kernel_route(h_dim, i_dim) == "generic"
    up_cols = (LARGE_NARROW_COLS if not wide_tiles_fit(i_dim)
               or tiles * cdiv(i_dim, LARGE_NARROW_COLS) <= sms else LARGE_WIDE_COLS)
    if generic and tiles * cdiv(i_dim, LARGE_SLIM_COLS) <= sms:
        up_cols = LARGE_SLIM_COLS
    if wide_tiles_fit(h_dim) and tiles * cdiv(h_dim, LARGE_WIDE_COLS) >= sms:
        return up_cols, LARGE_WIDE_COLS, 1
    steps = cdiv(i_dim, LARGE_DEPTH)
    if generic:
        return (up_cols, *generic_down_plan(tiles, h_dim, steps, sms))
    units = tiles * cdiv(h_dim, LARGE_NARROW_COLS)
    splits = max([d for d in range(1, steps // LARGE_MIN_STEPS + 1)
                  if steps % d == 0 and units * d <= sms] or [1])
    return up_cols, LARGE_NARROW_COLS, splits


def generic_down_plan(tiles: int, h_dim: int, steps: int, sms: int):
    """(tile columns, splits) of the generic route's second product over
    ``tiles`` token tiles: of 128- and 64-column tiles and the splits that
    keep the grid in one wave (each at least LARGE_MIN_STEPS of the
    ``steps`` k steps), the one whose block walks the least, in k steps of
    a 128-column tile (SLIM_STEP_COST each at 64 columns), with the split's
    partials and reduce counted (SPLIT_COST); on a tie 128 columns, then
    fewer splits. 128 columns unsplit where neither fits a wave. The plain
    rule (64 columns where a wave holds them, then the most splits that
    keep one wave) picks the same plans at 312 / 1,200 and 512 / 2,048 but
    not at the two shapes that need the model, at 512 tokens: 128 / 512,
    where its 2 splits of 8 steps cost ~7% more than none, and 1,024 /
    4,000, where its 64 columns split twice cost ~3.5% more than 128
    columns split 4 ways (scripts/k3_plans.py, NVIDIA H100 80GB HBM3,
    700.00 W)."""
    best = (float("inf"), LARGE_NARROW_COLS, 1)
    for cols, step_cost in ((LARGE_NARROW_COLS, 1.0), (LARGE_SLIM_COLS, SLIM_STEP_COST)):
        units = tiles * cdiv(h_dim, cols)
        for splits in range(1, max(1, steps // LARGE_MIN_STEPS) + 1):
            if units * splits > sms:
                break
            cost = cdiv(steps, splits) * step_cost + (
                SPLIT_COST[0] + SPLIT_COST[1] * splits if splits > 1 else 0.0)
            if cost < best[0]:
                best = (cost, cols, splits)
    return best[1], best[2]


def large_smem_bytes(cols: int) -> int:
    """Dynamic shared memory of a block of the 1,024 design with ``cols``-wide
    tiles (256, 128, or the generic route's 64), as csrc/fused_ffn.cu sizes
    it: its ring of stages (4 at 256 columns, else 6) of a 128 x 64 A tile
    and a 64 x ``cols`` B tile (bf16), each consumer warpgroup's staging
    tile of 64 rows x 128 output columns (bf16), and 1 KB of alignment."""
    stages = LARGE_WIDE_STAGES if cols == LARGE_WIDE_COLS else LARGE_NARROW_STAGES
    staging = 2 * 64 * LARGE_OUT_COLS * 2
    return stages * (LARGE_TOKENS * LARGE_DEPTH * 2 + LARGE_DEPTH * cols * 2) + staging + 1024


def large_scratch_bytes(n: int, i_dim: int, splits: int, h_dim: int = LARGE_HIDDEN) -> int:
    """Device memory the wrapper allocates for one call of the two products
    (the 1,024 design or the generic route): h [n, I] bf16, and the second
    product's [splits, n, H] f32 partials when its K axis is split."""
    return n * i_dim * 2 + (splits * n * h_dim * 4 if splits > 1 else 0)


def block_smem_bytes(h_dim: int) -> int:
    """Dynamic shared memory of a K3 block, as csrc/fused_ffn.cu sizes it,
    with 1 KB of alignment: at 384 both warpgroups' x rows (bf16) and a
    ring of 2 stages of one I chunk of W1 and of W2; at 768 the block's x
    rows, two h tiles and a ring of 4 stages of a 24 KB slab; at 1,024 the
    larger of the two tile widths' rings."""
    tokens, chunk, _ = KERNEL_TILING[h_dim]
    if h_dim == LARGE_HIDDEN:
        return max(large_smem_bytes(LARGE_WIDE_COLS), large_smem_bytes(LARGE_NARROW_COLS))
    if h_dim == WIDE_HIDDEN:
        return tokens * h_dim * 2 + WIDE_H_TILES * tokens * chunk * 2 + WIDE_STAGES * WIDE_SLAB_BYTES + 1024
    return tokens * h_dim * 2 + KERNEL_STAGES * (2 * h_dim * chunk * 2) + 1024


def accumulator_registers(h_dim: int) -> int:
    """f32 registers of an accumulator a thread of K3 holds: each of the two
    warpgroups (128 threads) owns 64 token rows and all of y (384), half of
    y's columns (768), or a wide tile's 256 columns of h or y (1,024)."""
    tokens, _, _ = KERNEL_TILING[h_dim]
    if h_dim == KERNEL_HIDDEN:
        return (tokens // 2) * h_dim // 128
    if h_dim == LARGE_HIDDEN:
        return 64 * LARGE_WIDE_COLS // 128
    return tokens * (h_dim // 2) // 128


def h_registers(h_dim: int) -> int:
    """f32 registers of h (one chunk's first product) a thread of K3 holds:
    64 rows by the chunk at 384, by its warpgroup's half of the chunk at
    768; none at 1,024, where h is the first product's output tile."""
    _, chunk, _ = KERNEL_TILING[h_dim]
    if h_dim == LARGE_HIDDEN:
        return 0
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
    route = kernel_route(h_dim, i_dim)
    if (route is None or w1.shape != (h_dim, i_dim)
            or w2.shape != (i_dim, h_dim) or b1.shape != (i_dim,) or b2.shape != (h_dim,)):
        raise ValueError(f"fused_ffn kernel (K3) takes H and I multiples of {GENERIC_GRANULE} "
                         f"(rows of whole 16-byte chunks); got x {tuple(orig_shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, _, splits = launch_plan(n, h_dim, i_dim, sms)
    partial = (torch.empty((splits, n, h_dim), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    args = [kernel_lib.ptr(t) for t in (x2d, w1, b1, w2, b2, out)]
    partial_ptr = kernel_lib.ptr(partial) if partial is not None else None
    if route != "fused":
        up_cols, down_cols, _ = large_launch_plan(n, i_dim, sms, h_dim)
        h = torch.empty((n, i_dim), dtype=x.dtype, device=dev)
        kernel_lib.launch("fused_ffn", "frag_fused_ffn_large", dev, *args, kernel_lib.ptr(h),
                          partial_ptr, n, h_dim, i_dim, up_cols, down_cols, splits)
    else:
        kernel_lib.launch("fused_ffn", "frag_fused_ffn", dev, *args, partial_ptr,
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
    """x [..., H] -> [..., H] in x.dtype. Differentiable in x and the
    weights. The CUDA kernels take bf16 x with H and I multiples of 8 (the
    weights are cast to x's dtype); at 384 and 768 the [.., I] intermediate
    stays on chip, at 1,024 and on the generic route it is a bf16 scratch
    in device memory (n x I x 2 bytes: at 1,024, 4.2 MB at 512 tokens, 285
    MB at 34,816, 1.07 GB at 131,072), beside the split second product's
    f32 partials at a query's sizes (8.4 MB at 512 tokens)."""
    return FusedFFN.apply(x, w1, b1, w2, b2)
