"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The shapes are
the awkward ones the main path can also produce (sequence lengths and token
counts that are not a multiple of the kernels' tiles, padded and fully
masked rows, one-tile corpora, dead slots, exact ties), at small batch. On
the GPU machine, where JAX is not installed, run them without the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.index.ivf import IVFIndex
from financial_rag_tpu_torch.models import decoder
from financial_rag_tpu_torch.ops import causal_flash as cf
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.ops import fused_ffn as ffn
from financial_rag_tpu_torch.ops import ivf_probe, kernel_lib
from financial_rag_tpu_torch.ops import pool_norm as pn
from financial_rag_tpu_torch.ops import topk

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _mask(b, s):
    """Row 0 full, row 1 padded, the last row fully masked."""
    mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
    mask[1, s // 3:] = 0
    mask[-1] = 0
    return mask


def _launches_once(mod, fn, key=None):
    """fn() launches the module's kernel exactly once (``key``: the
    wrapper's entry in a module that counts several kernels)."""
    count = (lambda: mod.LAUNCHES[key]) if key else (lambda: mod.LAUNCHES)
    before = count()
    out = fn()
    torch.cuda.synchronize()
    assert count() == before + 1
    return out


def test_launch_counts_lose_nothing_under_threads(gen):
    """The serving batchers launch kernels from many threads at once: 32
    threads x 40 launches each of K1 and K4, with the interpreter switching
    threads every microsecond, must count exactly 1,280 launches each (a
    read-modify-write on the counters without their lock loses some)."""
    import sys
    import threading

    hidden, mask = _randn(gen, 4, 64, 384, dtype=torch.bfloat16), _mask(4, 64)
    q, x = _randn(gen, 8, 384), _randn(gen, 1024, 384, dtype=torch.bfloat16)
    valid = torch.ones(1024, device="cuda")
    pn.masked_mean_l2_normalize(hidden, mask)          # load the library first
    before_k1, before_k4 = pn.LAUNCHES, topk.LAUNCHES["packed_topk_fused"]

    def worker():
        for _ in range(40):
            pn.masked_mean_l2_normalize(hidden, mask)
            topk.packed_topk_fused(q, x, valid, 8)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert pn.LAUNCHES - before_k1 == 32 * 40
    assert topk.LAUNCHES["packed_topk_fused"] - before_k4 == 32 * 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_norm_kernel_matches_plain(gen, dtype):
    hidden = _randn(gen, 3, 70, 384, dtype=DTYPES[dtype])
    mask = _mask(3, 70)
    out = _launches_once(pn, lambda: pn.masked_mean_l2_normalize(hidden, mask))
    ref = pn.masked_mean_l2_normalize_plain(hidden, mask)
    assert out.dtype == torch.float32 and out.shape == (3, 384)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", [(1, 1), (3, 70), (68, 512), (256, 512)])
def test_pool_norm_kernel_on_weighted_masks(gen, b, s, dtype):
    """Padded rows with holes and fractional weights (the mask multiplies
    h), a fully masked row (a zero vector) where B > 1: B = 68 and 256 also
    split the tokens of a row over a cluster of CTAs (68 x 2 or 4 < 2 x
    SMs), S = 1 and 70 take one CTA a row. Within 1e-5 of the plain
    version."""
    hidden = _randn(gen, b, s, 384, dtype=DTYPES[dtype])
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = s
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None]).float()
    mask *= (torch.rand(b, s, generator=gen, device="cuda") > 0.25).float()
    mask[::2] *= torch.rand(s, generator=gen, device="cuda")
    mask[0, 0] = 1.0
    if b > 1:
        mask[-1] = 0.0
    out = _launches_once(pn, lambda: pn.masked_mean_l2_normalize(hidden, mask))
    ref = pn.masked_mean_l2_normalize_plain(hidden, mask)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    if b > 1:
        assert (out[-1] == 0).all()
    again = pn.masked_mean_l2_normalize(hidden, mask)
    assert torch.equal(out, again)   # the cluster folds in rank order: the same bits


def test_pool_norm_kernel_rejects_what_it_cannot_take(gen):
    with pytest.raises(ValueError, match="multiple of 8"):
        pn.masked_mean_l2_normalize(_randn(gen, 2, 8, 36), torch.ones(2, 8, device="cuda"))
    h = _randn(gen, 2 * 8 * 384 + 1)[1:].view(2, 8, 384)   # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        pn.masked_mean_l2_normalize(h, torch.ones(2, 8, device="cuda"))


@pytest.mark.parametrize("s", [1, 64, 100, 512])
def test_flash_attention_kernel_matches_plain(gen, s):
    """bf16, so 3e-2 on O(1) outputs; S = 1 and 100 leave key tiles and
    query tiles part-filled; S = 1 and 64 take the one-warpgroup block."""
    b, h, atol = 3, 384, 3e-2
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    out = _launches_once(fa, lambda: fa.flash_attention(q, k, v, bias, num_heads=12))
    ref = fa.flash_attention_plain(q, k, v, bias, num_heads=12)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    # the fully masked row attends uniformly: the mean of v
    torch.testing.assert_close(out[-1].float(), v[-1].float().mean(0).expand(s, h),
                               atol=atol, rtol=0)


def test_flash_attention_kernel_skips_dead_key_tiles_exactly(gen):
    """S = 512 with long tails of padding (rows of 1, 65, 200 and 448 live
    keys) beside a full row and a fully masked one. Padding at -1e9 lies
    more than 2^20 (in log2 units) below each row's largest bias, so K2
    skips those key tiles; at -3e4 it walks them, and every such score's
    exponential is still exactly 0. Rows with a live key must come out the
    same to the bit both ways, and within 3e-2 of the plain version; the
    fully masked row must be the mean of v over all 512 keys."""
    b, s, h = 6, 512, 384
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    lens = torch.tensor([512, 1, 65, 200, 448, 0], device="cuda")
    live = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    skip = _launches_once(fa, lambda: fa.flash_attention(
        q, k, v, torch.where(live, 0.0, -1e9).float(), num_heads=12))
    walk = fa.flash_attention(q, k, v, torch.where(live, 0.0, -3e4).float(), num_heads=12)
    assert torch.equal(skip[:-1], walk[:-1])
    ref = fa.flash_attention_plain(q, k, v, torch.where(live, 0.0, -1e9).float(), num_heads=12)
    torch.testing.assert_close(skip.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(skip[-1].float(), v[-1].float().mean(0).expand(s, h),
                               atol=3e-2, rtol=0)


def test_flash_attention_kernel_skips_leading_dead_key_tiles_exactly(gen):
    """S = 300 with the padding in front (live keys from 130, 250 and 299 on,
    beside a full row): key tile 0, whose copies start before the bias scan,
    is dead in those rows and walked all the same, its sums scaled away by
    the first live tile's alpha of exactly 0. Skipped (-1e9) and walked
    (-3e4) padding give the same bits; both within 3e-2 of the plain
    version."""
    b, s, h = 4, 300, 384
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    first = torch.tensor([0, 130, 250, 299], device="cuda")
    live = torch.arange(s, device="cuda")[None, :] >= first[:, None]
    skip = _launches_once(fa, lambda: fa.flash_attention(
        q, k, v, torch.where(live, 0.0, -1e9).float(), num_heads=12))
    walk = fa.flash_attention(q, k, v, torch.where(live, 0.0, -3e4).float(), num_heads=12)
    assert torch.equal(skip, walk)
    ref = fa.flash_attention_plain(q, k, v, torch.where(live, 0.0, -1e9).float(), num_heads=12)
    torch.testing.assert_close(skip.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("heads", [3, 6])
def test_flash_attention_kernel_at_local_head_counts(gen, heads):
    """K2 at K11's local head counts (rows of 96 and 192 values), S = 200
    (the last key tile and the second query warpgroup part-filled), padded
    and fully masked rows: within 3e-2 of the plain version; the fully
    masked row is the mean of v."""
    b, s = 3, 200
    h = heads * 32
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    out = _launches_once(fa, lambda: fa.flash_attention(q, k, v, bias, num_heads=heads))
    ref = fa.flash_attention_plain(q, k, v, bias, num_heads=heads)
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(out[-1].float(), v[-1].float().mean(0).expand(s, h),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("b,s", [(2, 50), (8, 64), (300, 64)])
def test_fused_ffn_kernel_matches_plain(gen, b, s):
    """100 tokens (one ragged tile of 128) and a query batch's 512 split the
    I axis over many blocks and sum f32 partials; 19,200 tokens fill the
    card with one block per tile."""
    bf16 = torch.bfloat16
    x = _randn(gen, b, s, 384, dtype=bf16)
    w1 = _randn(gen, 384, 1536, dtype=bf16, scale=384 ** -0.5)
    w2 = _randn(gen, 1536, 384, dtype=bf16, scale=1536 ** -0.5)
    b1, b2 = _randn(gen, 1536, dtype=bf16, scale=0.1), _randn(gen, 384, dtype=bf16, scale=0.1)
    out = _launches_once(ffn, lambda: ffn.fused_ffn(x, w1, b1, w2, b2))
    ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
    assert out.dtype == bf16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("n", [999, 129, 17030])
def test_fused_ffn_kernel_on_ragged_token_counts(gen, n):
    """Token counts that are not a multiple of the 128-token tile: 999 (8
    tiles, the I axis split, as a query-sized call takes it), 129 (a tile of
    one token), 17,030 (134 tiles, no split). The kernel zero-fills the last
    tile itself; within 3e-2 of the plain version."""
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = ffn.split_count(-(-n // ffn.KERNEL_TOKENS), 1536 // ffn.KERNEL_CHUNK, sms)
    assert (splits > 1) == (n < 17030)
    x = _randn(gen, n, 384, dtype=bf16)
    w1 = _randn(gen, 384, 1536, dtype=bf16, scale=384 ** -0.5)
    w2 = _randn(gen, 1536, 384, dtype=bf16, scale=1536 ** -0.5)
    b1, b2 = _randn(gen, 1536, dtype=bf16, scale=0.1), _randn(gen, 384, dtype=bf16, scale=0.1)
    out = _launches_once(ffn, lambda: ffn.fused_ffn(x, w1, b1, w2, b2))
    ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


def test_flash_attention_kernel_rejects_float32(gen):
    x = _randn(gen, 2, 64, 384)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(x, x, x, torch.zeros(2, 64, device="cuda"), num_heads=12)


def test_fused_ffn_kernel_rejects_float32(gen):
    x = _randn(gen, 64, 384)
    w1, w2 = _randn(gen, 384, 1536), _randn(gen, 1536, 384)
    with pytest.raises(TypeError, match="bfloat16"):
        ffn.fused_ffn(x, w1, _randn(gen, 1536), w2, _randn(gen, 384))


# ------------------------------------------------ the bge-base width (768)


@pytest.mark.parametrize("heads,b,s", [(12, 3, 1), (12, 3, 64), (12, 3, 100), (12, 2, 512),
                                        (12, 130, 70), (16, 3, 1), (16, 3, 64), (16, 3, 100),
                                        (16, 2, 512), (16, 68, 512)])
def test_flash_attention_kernel_at_head_dim_64(gen, heads, b, s):
    """K2 at 12 heads of 64 (hidden 768) and at bge-large's 16 (hidden
    1,024): S = 1, 64 (one warpgroup a block), 100 and 70 (part-filled key
    and query tiles), 512; a padded row and a fully masked one (the mean of
    v), B = 130 (not a multiple of anything) and the large ingest's 68 x
    512. Within 3e-2 of the plain version."""
    h = 64 * heads
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    width_before = fa.WIDTH_LAUNCHES[h]
    out = _launches_once(fa, lambda: fa.flash_attention(q, k, v, bias, num_heads=heads))
    assert fa.WIDTH_LAUNCHES[h] == width_before + 1
    ref = fa.flash_attention_plain(q, k, v, bias, num_heads=heads)
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(out[-1].float(), v[-1].float().mean(0).expand(s, h),
                               atol=3e-2, rtol=0)


def test_flash_attention_kernel_at_head_dim_64_skips_dead_key_tiles_exactly(gen):
    """The dead-key argument at head_dim 64: padding at -1e9 (skipped tiles)
    and at -3e4 (walked, every exponential exactly 0) give the same bits for
    every row with a live key, leading and trailing padding alike."""
    b, s, h = 5, 300, 768
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    pos = torch.arange(s, device="cuda")[None, :]
    lo = torch.tensor([0, 0, 130, 250, 0], device="cuda")[:, None]
    hi = torch.tensor([300, 1, 300, 300, 65], device="cuda")[:, None]
    live = (pos >= lo) & (pos < hi)
    skip = _launches_once(fa, lambda: fa.flash_attention(
        q, k, v, torch.where(live, 0.0, -1e9).float(), num_heads=12))
    walk = fa.flash_attention(q, k, v, torch.where(live, 0.0, -3e4).float(), num_heads=12)
    assert torch.equal(skip, walk)
    ref = fa.flash_attention_plain(q, k, v, torch.where(live, 0.0, -1e9).float(), num_heads=12)
    torch.testing.assert_close(skip.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("heads", [3, 6])
def test_flash_attention_kernel_at_local_heads_of_64(gen, heads):
    """K2 at K11's local head counts of 64 (rows of 192 and 384 values),
    S = 300 (attn_fwd_d64_kernel: three 128-key tiles, the last part-filled,
    and a second query block of 44 rows), with keys live up to 1, 65, 130
    and 257 (the last live key inside a 128-key tile) and a fully masked
    row: within 3e-2 of the plain version; the fully masked row is the mean
    of v."""
    b, s = 5, 300
    h = heads * 64
    assert fa.fwd_kernel(s, 64) == "attn_fwd_d64_kernel"
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    lens = torch.tensor([1, 65, 130, 257, 0], device="cuda")
    bias = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0, -1e9).float()
    out = _launches_once(fa, lambda: fa.flash_attention(q, k, v, bias, num_heads=heads))
    ref = fa.flash_attention_plain(q, k, v, bias, num_heads=heads)
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(out[-1].float(), v[-1].float().mean(0).expand(s, h),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("h,n,i", [
    *((768, n, 3072) for n in (1, 64, 65, 129, 193, 512, 999, 17030, 34816, 131072)),
    *((768, n, 2048) for n in (129, 999, 17030))])
def test_fused_ffn_kernel_at_hidden_768(gen, h, n, i):
    """K3's 768-wide design at I = 3,072 (bge-base) and 2,048: 1, 65, 129,
    193, 999 and 17,030 tokens leave the last 64-token tile ragged (65, 129
    and 193 are 2, 3 and 4 tiles); up to 999 the I axis is split and f32
    partials are summed, from 17,030 on one block a tile. Within 3e-2 of
    the plain version."""
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, _, splits = ffn.launch_plan(n, h, i, sms)
    assert (splits > 1) == (n < 17030)
    assert -(-n // 64) * splits <= sms or splits == 1
    x = _randn(gen, n, h, dtype=bf16)
    w1 = _randn(gen, h, i, dtype=bf16, scale=h ** -0.5)
    w2 = _randn(gen, i, h, dtype=bf16, scale=i ** -0.5)
    b1, b2 = _randn(gen, i, dtype=bf16, scale=0.1), _randn(gen, h, dtype=bf16, scale=0.1)
    width_before = ffn.WIDTH_LAUNCHES[h]
    out = _launches_once(ffn, lambda: ffn.fused_ffn(x, w1, b1, w2, b2))
    assert ffn.WIDTH_LAUNCHES[h] == width_before + 1
    ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("n,i", [
    *((n, 4096) for n in (1, 63, 129, 512, 999, 17030, 34816, 131072)),
    *((n, 2048) for n in (129, 999, 17030)),
    *((n, 4032) for n in (1, 512, 5000))])
def test_fused_ffn_kernel_at_hidden_1024(gen, n, i):
    """K3's 1,024 design (two products through h in device memory, tiles of
    128 tokens) at I = 4,096 (bge-large), 2,048 and 4,032 (no multiple of
    the 256-column tile: the last tile's columns past I read as zeros and
    are not stored): 1, 63, 129, 999, 5,000 and 17,030 tokens leave the
    last tile ragged; up to 999 the second product's K axis is split and
    its f32 partials summed in split order, from 17,030 on it is not. One
    launch counted, within 3e-2 of the plain version."""
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    up_cols, down_cols, splits = ffn.large_launch_plan(n, i, sms)
    assert (splits > 1) == (n <= 999)
    x = _randn(gen, n, 1024, dtype=bf16)
    w1 = _randn(gen, 1024, i, dtype=bf16, scale=1024 ** -0.5)
    w2 = _randn(gen, i, 1024, dtype=bf16, scale=i ** -0.5)
    b1, b2 = _randn(gen, i, dtype=bf16, scale=0.1), _randn(gen, 1024, dtype=bf16, scale=0.1)
    width_before = ffn.WIDTH_LAUNCHES[1024]
    out = _launches_once(ffn, lambda: ffn.fused_ffn(x, w1, b1, w2, b2))
    assert ffn.WIDTH_LAUNCHES[1024] == width_before + 1
    ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("n", [1, 512, 999, 34816])
@pytest.mark.parametrize("h", [768, 1024])
def test_fused_ffn_kernel_at_hidden_768_is_deterministic(gen, h, n):
    """Two calls of K3's 768- or 1,024-wide design on the same inputs give
    the same bits: each block (each output tile, at 1,024) sums its products
    in a fixed order, and the split partials are summed in split order (N
    up to 999)."""
    bf16 = torch.bfloat16
    i = 4 * h
    x = _randn(gen, n, h, dtype=bf16)
    w1 = _randn(gen, h, i, dtype=bf16, scale=h ** -0.5)
    w2 = _randn(gen, i, h, dtype=bf16, scale=i ** -0.5)
    b1, b2 = _randn(gen, i, dtype=bf16, scale=0.1), _randn(gen, h, dtype=bf16, scale=0.1)
    first = ffn.fused_ffn(x, w1, b1, w2, b2)
    second = ffn.fused_ffn(x, w1, b1, w2, b2)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h", [(70, 130, 768), (68, 512, 1024)])
def test_pool_norm_kernel_at_hidden_768(gen, b, s, h, dtype):
    """K1 at hidden 768 and at the large ingest's 68 x 512 x 1,024."""
    hidden = _randn(gen, b, s, h, dtype=DTYPES[dtype])
    mask = _mask(b, s)
    out = _launches_once(pn, lambda: pn.masked_mean_l2_normalize(hidden, mask))
    ref = pn.masked_mean_l2_normalize_plain(hidden, mask)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [208, 1024, 4096, 102400])
@pytest.mark.parametrize("bq", [1, 8, 65, 128, 192])
@pytest.mark.parametrize("d", [768, 1024])
def test_packed_topk_kernel_at_d768_exactly(gen, d, bq, n):
    """K4's 768-wide sweep (one warpgroup, 2 stages) and its 1,024-wide one
    (one warpgroup, 16 bucket columns a block, 3 stages) on exact-grid data
    with ties and 5% dead rows: N = 208 (one ragged tile of 6.5 or 13
    column blocks), one tile, 4 and 100 tiles; Bq on both sides of the
    64-query tile. Bit for bit the plain version."""
    q, x = _grid(gen, bq, d), _grid(gen, n, d)
    if n >= 2048:
        x[1024:2048] = x[:1024]
    x[min(70, n - 1)] = x[5]
    x = x.bfloat16()
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.05).float()
    k = min(24, n)
    out_s, out_i = _launches_once(topk, lambda: topk.packed_topk_fused(q, x, valid, k),
                                  "packed_topk_fused")
    ref_s, ref_i = topk.packed_topk_fused_plain(q, x, valid, k)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


@pytest.mark.parametrize("d", [400, 512, 800, 1008])
def test_packed_topk_kernel_between_the_widths(gen, d):
    """384 < D < 768 takes the 768-wide sweep, 768 < D < 1,024 the
    1,024-wide one, with the features past D zero: bit for bit the plain
    version."""
    q, x = _grid(gen, 70, d), _grid(gen, 4096, d).bfloat16()
    valid = (torch.rand(4096, generator=gen, device="cuda") > 0.05).float()
    out = _launches_once(topk, lambda: topk.packed_topk_fused(q, x, valid, 24), "packed_topk_fused")
    ref = topk.packed_topk_fused_plain(q, x, valid, 24)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])


@pytest.mark.parametrize("name", ["bucketed_topk_fused", "bucketed_topk"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("n", [1024, 4096, 16384, 102400])
@pytest.mark.parametrize("bq", [1, 65, 128, 200])
@pytest.mark.parametrize("d", [768, 1024])
def test_bucketed_sweeps_at_d768_exactly(gen, d, name, bq, n, dtype):
    """K5 and K7 at D = 768: int8 (two query warpgroups, a 5-stage ring)
    and bf16 (one warpgroup, 2 stages), and at D = 1,024: int8 (one query
    warpgroup, 5 stages of 32 rows) and bf16 (one warpgroup, 3 stages of 16
    rows), on exact-grid data with ties and 5% dead rows: the int8 sweep's
    integer dots (127 * 127 * 1,024 < 2^24) and both sweeps' selection bit
    for bit the plain version."""
    kernel, plain = SWEEPS[name]
    q, x, valid = _hopper_sweep_case(gen, bq, n, dtype, d=d)
    out_s, out_i = _launches_once(topk, lambda: kernel(q, x, valid, 24), name)
    ref_s, ref_i = plain(q, x, valid, 24)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("d", [768, 1024])
def test_probe_kernel_at_d768(gen, d, dtype):
    """K8 at D 768 and 1,024."""
    nlist, L, B, P = 16, 128, 9, 5
    if dtype == "int8":
        storage = torch.randint(-127, 128, (nlist, L, d), generator=gen, device="cuda").to(torch.int8)
        q = torch.randint(-127, 128, (B, d), generator=gen, device="cuda").to(torch.int8)
        weights = torch.full((nlist, L), 1.0 / 127.0, device="cuda")
    else:
        storage = _randn(gen, nlist, L, d, scale=d ** -0.5).to(torch.bfloat16)
        q = _randn(gen, B, d, scale=d ** -0.5).to(torch.bfloat16)
        weights = torch.ones(nlist, L, device="cuda")
    weights[:, 100:] = 0.0
    probes = torch.randint(0, nlist, (B, P), generator=gen, device="cuda", dtype=torch.int32)
    out = _launches_once(ivf_probe, lambda: ivf_probe.probe_scores(q, storage, weights, probes))
    ref = ivf_probe.probe_scores_plain(q, storage, weights, probes)
    if dtype == "int8":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_wide_kernels_reject_what_they_cannot_take(gen):
    """K2 and K10 above head_dim 64 (128 and 80), K3 where a row is not
    whole 16-byte chunks (hidden 100; I 3,004 at 768 and 4,004 at 1,024):
    raised before any launch, never the plain version."""
    bf16 = torch.bfloat16
    bias = torch.zeros(2, 64, device="cuda")
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.LAUNCHES)
    for heads in (8, 12):   # heads of 128 and of 80 at hidden 1,024 and 960
        x = _randn(gen, 2, 64, 1024 if heads == 8 else 960, dtype=bf16)
        with pytest.raises(ValueError, match=r"\(K2\) takes head_dim <= 64"):
            fa.flash_attention(x, x, x, bias, num_heads=heads)
        with pytest.raises(ValueError, match=r"\(K10\) takes head_dim <= 64"):
            fa.flash_attention_bwd(x, x, x, bias, x, num_heads=heads)
    for h, i in ((100, 400), (768, 3004), (1024, 4004)):
        x = _randn(gen, 64, h, dtype=bf16)
        w1, w2 = _randn(gen, h, i, dtype=bf16), _randn(gen, i, h, dtype=bf16)
        with pytest.raises(ValueError, match=r"\(K3\) takes H and I multiples of 8"):
            ffn.fused_ffn(x, w1, _randn(gen, i, dtype=bf16), w2, _randn(gen, h, dtype=bf16))
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.LAUNCHES) == before


# ----------------------------------------------------- the generic routes

GENERIC_FFN_CASES = [(h, i, n) for h, i in ((312, 1200), (128, 512), (512, 2048), (1024, 4000))
                     for n in (32768, 512, 999, 1)]


@pytest.mark.parametrize("h,i,n", GENERIC_FFN_CASES)
def test_fused_ffn_kernel_on_the_generic_route(gen, h, i, n):
    """K3's generic route (the two products at run-time extents) at
    TinyBERT-L-4's 312 / 1,200, TinyBERT-L-2's 128 / 512, BERT-Small's
    512 / 2,048 and 1,024 / 4,000, at a 64 x 512 rerank batch, a query's
    512 tokens, 999 and 1: one launch counted at its width, within 3e-2 of
    the plain version, and the same bits twice."""
    bf16 = torch.bfloat16
    assert ffn.kernel_route(h, i) == "generic"
    x = _randn(gen, n, h, dtype=bf16)
    w1 = _randn(gen, h, i, dtype=bf16, scale=h ** -0.5)
    w2 = _randn(gen, i, h, dtype=bf16, scale=i ** -0.5)
    b1, b2 = _randn(gen, i, dtype=bf16, scale=0.1), _randn(gen, h, dtype=bf16, scale=0.1)
    width_before = ffn.WIDTH_LAUNCHES[h]
    out = _launches_once(ffn, lambda: ffn.fused_ffn(x, w1, b1, w2, b2))
    assert ffn.WIDTH_LAUNCHES[h] == width_before + 1
    ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
    assert torch.equal(out, ffn.fused_ffn(x, w1, b1, w2, b2))


GENERIC_ATTENTION_CASES = [(d, b, s) for d in (26, 16, 48) for b, s in ((64, 512), (8, 64))]


@pytest.mark.parametrize("head_dim,b,s", GENERIC_ATTENTION_CASES)
def test_flash_attention_kernels_on_padded_heads(gen, head_dim, b, s):
    """K2 and K10 at 12 heads of 26 (TinyBERT-L-4), 16 and 48 (once
    zero-padded to 32 or 64, since read in place) with the scale of the
    true head_dim: a padded row and a fully masked one. The forward within 3e-2 of the plain version (its
    launch counted at the true width), the backward's dq, dk and dv within
    2^-6 of every (position, head) row's largest value, masked keys'
    gradients exactly zero."""
    heads, h = 12, 12 * head_dim
    q, k, v, do = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(4))
    mask = _mask(b, s)
    bias = torch.where(mask > 0, 0.0, -1e9).float()
    width_before = fa.WIDTH_LAUNCHES[h]
    out = _launches_once(fa, lambda: fa.flash_attention(q, k, v, bias, num_heads=heads))
    assert fa.WIDTH_LAUNCHES[h] == width_before + 1
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v, bias, num_heads=heads).float(),
                               atol=3e-2, rtol=0)
    before = fa.BWD_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, bias, do, num_heads=heads)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == q.shape and torch.isfinite(g.float()).all(), name
        assert _row_rel_err(g, w, heads) <= 2.0 ** -6, (name, _row_rel_err(g, w, heads))
    assert (got[1][1, s // 3:] == 0).all() and (got[2][1, s // 3:] == 0).all()


def test_flash_attention_padded_route_sees_a_wrong_scale(gen):
    """The control of the padded route: heads of 26 run as if they were 32
    wide (zero-padded, the padded width's scale) miss the plain version's
    3e-2 at B=64 S=512, where the right scale is within it."""
    from financial_rag_tpu_torch.ops.common import pad_heads, unpad_heads

    q, k, v = (_randn(gen, 64, 512, 12 * 26, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(64, 512) > 0, 0.0, -1e9).float()
    ref = fa.flash_attention_plain(q, k, v, bias, num_heads=12).float()
    wrong = unpad_heads(fa.flash_attention(*(pad_heads(t, 12, 32) for t in (q, k, v)), bias,
                                           num_heads=12), 12, 26)
    assert (wrong.float() - ref).abs().max() > 3e-2
    right = fa.flash_attention(q, k, v, bias, num_heads=12)
    assert (right.float() - ref).abs().max() <= 3e-2


IN_PLACE_CASES = [(d, b, s) for d in (26, 16, 48) for b, s in ((64, 512), (8, 64))]


def _no_pad_copies(monkeypatch):
    """Make the wrapper's pad copy fail: the widths read in place make none."""
    def refuse(*args, **kwargs):
        raise AssertionError("K2 padded a head it reads in place")
    monkeypatch.setattr(fa, "pad_heads", refuse)
    monkeypatch.setattr(fa, "unpad_heads", refuse)


def _k2_entry(q, k, v, bias, out, heads: int, head_dim: int):
    """K2's C entry on q, k, v and out as they lie ([B, S, H], H = the
    tensors' width)."""
    b, s, h = q.shape
    kernel_lib.launch("flash_attention", "frag_flash_attention", q.device,
                      *(kernel_lib.ptr(t) for t in (q, k, v, bias, out)), b, s, h, heads, head_dim)
    torch.cuda.synchronize()


@pytest.mark.parametrize("head_dim,b,s", IN_PLACE_CASES)
def test_flash_attention_kernel_reads_narrow_heads_in_place(gen, monkeypatch, head_dim, b, s):
    """K2 at 12 heads of 26, 16 and 48, B=64 S=512 and B=8 S=64 (the
    one-warpgroup block): read where they lie (no pad copy, the C entry
    given H = 12 * head_dim; 16 and 48 through 4-D maps, 26 through 16-byte
    aligned windows at offsets 0 to 6), a padded row and a fully masked
    one, within 3e-2 of the plain version, the same bits twice."""
    assert fa.fwd_reads_in_place(head_dim, s, 12 * head_dim)
    _no_pad_copies(monkeypatch)
    heads, h = 12, 12 * head_dim
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    out = _launches_once(fa, lambda: fa.flash_attention(q, k, v, bias, num_heads=heads))
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v, bias, num_heads=heads).float(),
                               atol=3e-2, rtol=0)
    assert torch.equal(out, fa.flash_attention(q, k, v, bias, num_heads=heads))


@pytest.mark.parametrize("head_dim,b,s", IN_PLACE_CASES)
def test_flash_attention_in_place_heads_are_isolated(gen, head_dim, b, s):
    """What lies in head g+1's columns of q, k and v reaches nothing of head
    g's output: new random values there leave every other head's output
    bit-identical."""
    heads, h = 12, 12 * head_dim
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    out = fa.flash_attention(q, k, v, bias, num_heads=heads)
    g = 5
    cols = slice((g + 1) * head_dim, (g + 2) * head_dim)
    for t in (q, k, v):
        t[..., cols] = _randn(gen, b, s, head_dim, dtype=torch.bfloat16, scale=4.0)
    again = fa.flash_attention(q, k, v, bias, num_heads=heads)
    assert not torch.equal(again[..., cols], out[..., cols])
    keep = torch.ones(h, dtype=torch.bool, device="cuda")
    keep[cols] = False
    assert torch.equal(again[..., keep], out[..., keep])


@pytest.mark.parametrize("head_dim,b,s", IN_PLACE_CASES)
def test_flash_attention_in_place_writes_only_the_output(gen, head_dim, b, s):
    """Into a NaN-filled out with a guard region after it, K2 in place
    writes every element of out (no NaN left) and nothing past it."""
    heads, h = 12, 12 * head_dim
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    guard = 4096
    buf = torch.full((b * s * h + guard,), float("nan"), dtype=torch.bfloat16, device="cuda")
    buf[b * s * h:] = 7.0
    out = buf[:b * s * h].view(b, s, h)
    _k2_entry(q, k, v, bias, out, heads, head_dim)
    assert not torch.isnan(out.float()).any()
    assert (buf[b * s * h:] == 7.0).all()
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v, bias, num_heads=heads).float(),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("head_dim,s", [(25, 512), (25, 64), (50, 512), (30, 512)])
def test_flash_attention_copied_widths_match_plain(gen, head_dim, s):
    """The widths K2's route rule sends to the padded copy (an odd
    head_dim, 50 above S = 64, and 30, whose 16-byte aligned window would
    not fit 32 columns) still match the plain version within 3e-2; the C
    entry refuses them in place."""
    assert not fa.fwd_reads_in_place(head_dim, s, 12 * head_dim)
    heads, b = 12, 8
    h = heads * head_dim
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    out = _launches_once(fa, lambda: fa.flash_attention(q, k, v, bias, num_heads=heads))
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v, bias, num_heads=heads).float(),
                               atol=3e-2, rtol=0)
    with pytest.raises(RuntimeError):
        _k2_entry(q, k, v, bias, torch.empty_like(q), heads, head_dim)


@pytest.mark.parametrize("heads,tp", [(6, None), (3, None), (12, 2), (12, 4)])
def test_flash_attention_heads_of_26_over_rows_of_partial_chunks(gen, monkeypatch, heads, tp):
    """Heads of 26 over rows that are not a multiple of 8 columns (6 or 3
    heads; TinyBERT-L-4's 12 through K11 at tp 2 or 4, 6 or 3 local heads)
    take the padded copy, as the window's 3-D map needs rows of whole
    16-byte chunks: B=4 S=512, a padded row and a fully masked one, the
    output within 3e-2 of the plain version and dq/dk/dv within 2^-6 of
    each row's largest value of the plain backward; the C entry refuses
    them in place."""
    head_dim, b, s = 26, 4, 512
    local = heads // (tp or 1)
    assert not fa.fwd_reads_in_place(head_dim, s, local * head_dim)
    pads = []
    real_pad = fa.pad_heads
    monkeypatch.setattr(fa, "pad_heads", lambda *a: pads.append(a[2]) or real_pad(*a))
    h = local * head_dim
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16).requires_grad_() for _ in range(3))
    do = _randn(gen, b, s, h, dtype=torch.bfloat16)
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    if tp is None:
        out = fa.flash_attention(q, k, v, bias, num_heads=heads)
    else:
        out = fa.flash_attention_tp(q, k, v, bias, num_heads=heads, mesh=_ModelAxis(tp),
                                    head_dim=head_dim)
    assert pads == [32] * 3
    got = torch.autograd.grad(out, (q, k, v), do)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    torch.testing.assert_close(out.detach().float(),
                               fa.flash_attention_plain(qd, kd, vd, bias, num_heads=local).float(),
                               atol=3e-2, rtol=0)
    want = fa.flash_attention_bwd_plain(qd, kd, vd, bias, do, num_heads=local)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _row_rel_err(g, w, local) <= 2.0 ** -6, (name, _row_rel_err(g, w, local))
    with pytest.raises(RuntimeError):
        _k2_entry(qd, kd, vd, bias, torch.empty_like(qd), local, head_dim)


@pytest.mark.parametrize("head_dim", [16, 48, 26])
def test_flash_attention_in_place_non_finite_neighbour_keys(gen, head_dim):
    """An inf in the first column of head g+1's k at one key of batch row
    0 leaves head g's output bit-identical, as the TPU kernel's slice of
    the head does. At 16 and 48 (4-D maps) head g's box reads zeros past
    its columns. At 26 head g's 16-byte aligned window (g = 5: columns
    128-159, the head at 130-155) holds that column, and K's columns
    outside the head are zeroed in shared memory with Q's, so no 0 x inf
    reaches head g's scores. Every other head and batch row stays
    bit-identical too."""
    heads, b, s, g = 12, 4, 512, 5
    h = heads * head_dim
    q, k, v = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.zeros(b, s, device="cuda")
    out = fa.flash_attention(q, k, v, bias, num_heads=heads)
    k[0, 7, (g + 1) * head_dim] = float("inf")
    again = fa.flash_attention(q, k, v, bias, num_heads=heads)
    head = slice(g * head_dim, (g + 1) * head_dim)
    keep = torch.ones(h, dtype=torch.bool, device="cuda")
    keep[g * head_dim:(g + 2) * head_dim] = False
    assert torch.equal(again[1:], out[1:])
    assert torch.equal(again[0][:, keep], out[0][:, keep])
    assert torch.equal(again[0, :, head], out[0, :, head])


# --------------------------------------- K10 and K9 read narrow heads in place

BWD_IN_PLACE_CASES = [(d, b, s) for d in (26, 16, 48) for b, s in ((64, 512), (8, 64), (16, 128))]


def _no_bwd_pad_copies(monkeypatch):
    """Make the pad copies fail: K10 at the widths it reads in place makes none."""
    def refuse(*args, **kwargs):
        raise AssertionError("K10 padded a head it reads in place")
    monkeypatch.setattr(fa, "pad_heads", refuse)
    monkeypatch.setattr(fa, "unpad_heads", refuse)


def _k10_entry(q, k, v, bias, do, grads, heads: int, head_dim: int):
    """K10's C entry on q, k, v, dout and grads (dq, dk, dv) as they lie
    ([B, S, H], H = the tensors' width)."""
    b, s, h = q.shape
    stats = torch.empty(fa.bwd_scratch_shape(b, s, heads), dtype=torch.float32, device="cuda")
    kernel_lib.launch("flash_attention_bwd", "frag_flash_attention_bwd", q.device,
                      *(kernel_lib.ptr(t) for t in (q, k, v, bias, do, *grads, stats)), b, s, h,
                      heads, head_dim)
    torch.cuda.synchronize()


@pytest.mark.parametrize("head_dim,b,s", BWD_IN_PLACE_CASES)
def test_flash_attention_bwd_reads_narrow_heads_in_place(gen, monkeypatch, head_dim, b, s):
    """K10 at 12 heads of 26, 16 and 48, B=64 S=512, B=8 S=64 and B=16
    S=128 (48 there through the fused kernel's 4-D maps; 26 through 16-byte
    aligned windows at offsets 0 to 6; 16 through the 32-wide kernels'
    copies): read where they lie (no pad copy, the C entry given H = 12 *
    head_dim), a padded row and a fully masked one, dq, dk and dv within
    2^-6 of every (position, head) row's largest value of the plain
    version, masked keys' dk and dv exactly zero, the same bits twice."""
    assert fa.bwd_reads_in_place(head_dim, 12 * head_dim)
    _no_bwd_pad_copies(monkeypatch)
    heads, h = 12, 12 * head_dim
    q, k, v, do = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(4))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    before = fa.BWD_IN_PLACE_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    again = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    torch.cuda.synchronize()
    assert fa.BWD_IN_PLACE_LAUNCHES == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, bias, do, num_heads=heads)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        assert g.shape == q.shape and torch.isfinite(g.float()).all(), name
        assert _row_rel_err(g, w, heads) <= 2.0 ** -6, (name, _row_rel_err(g, w, heads))
        assert torch.equal(g, a), name
    assert (got[1][1, s // 3:] == 0).all() and (got[2][1, s // 3:] == 0).all()


@pytest.mark.parametrize("head_dim,b,s", BWD_IN_PLACE_CASES)
def test_flash_attention_bwd_in_place_heads_are_isolated(gen, head_dim, b, s):
    """New random values in head g+1's columns of q, k, v and dO change
    head g+1's dq, dk and dv and leave every other head's bit-identical;
    so does an inf in each of those four tensors' columns of heads g-1 and
    g+1 next to head g (inside its window at 26) for head g."""
    heads, h, g = 12, 12 * head_dim, 5
    ins = [_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(4)]
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    first = fa.flash_attention_bwd(*ins[:3], bias, ins[3], num_heads=heads)
    cols = slice((g + 1) * head_dim, (g + 2) * head_dim)
    for t in ins:
        t[..., cols] = _randn(gen, b, s, head_dim, dtype=torch.bfloat16, scale=4.0)
    second = fa.flash_attention_bwd(*ins[:3], bias, ins[3], num_heads=heads)
    keep = torch.ones(h, dtype=torch.bool, device="cuda")
    keep[cols] = False
    for a, c in zip(first, second):
        assert not torch.equal(a[..., cols], c[..., cols])
        assert torch.equal(a[..., keep], c[..., keep])
    for t in ins:
        t[0, 3, (g + 1) * head_dim] = float("inf")
        t[0, 5, g * head_dim - 1] = float("-inf")
    third = fa.flash_attention_bwd(*ins[:3], bias, ins[3], num_heads=heads)
    head = slice(g * head_dim, (g + 1) * head_dim)
    for a, c in zip(second, third):
        assert torch.equal(a[..., head], c[..., head])


@pytest.mark.parametrize("head_dim,b,s", BWD_IN_PLACE_CASES)
def test_flash_attention_bwd_in_place_writes_only_its_outputs(gen, head_dim, b, s):
    """Into NaN-filled dq, dk and dv, each with a guard region after it,
    K10 in place writes every element (no NaN left) and nothing past them;
    the values within 2^-6 per row of the plain version."""
    heads, h = 12, 12 * head_dim
    q, k, v, do = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(4))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    guard, n = 4096, b * s * h
    bufs = [torch.full((n + guard,), float("nan"), dtype=torch.bfloat16, device="cuda")
            for _ in range(3)]
    for buf in bufs:
        buf[n:] = 7.0
    grads = [buf[:n].view(b, s, h) for buf in bufs]
    _k10_entry(q, k, v, bias, do, grads, heads, head_dim)
    want = fa.flash_attention_bwd_plain(q, k, v, bias, do, num_heads=heads)
    for name, buf, g, w in zip(("dq", "dk", "dv"), bufs, grads, want):
        assert not torch.isnan(g.float()).any(), name
        assert (buf[n:] == 7.0).all(), name
        assert _row_rel_err(g, w, heads) <= 2.0 ** -6, (name, _row_rel_err(g, w, heads))


@pytest.mark.parametrize("head_dim,s", [(16, 512), (16, 64), (48, 512), (48, 128), (48, 64)])
def test_flash_attention_bwd_in_place_is_the_padded_copy_to_the_bit(gen, head_dim, s):
    """A head of whole 16-byte chunks read in place is the padded copy the
    kernel reads at the built width, to the bit: its columns past the head
    come in as zeros either way, and dq, dk and dv match the padded
    route's (the C entry on heads zero-padded to 32 or 64, the padded
    columns dropped) on every path (the 32-wide kernels at 16, the 64-wide
    two kernels and the fused kernel at 48)."""
    from financial_rag_tpu_torch.ops.common import built_head_dim, pad_heads, unpad_heads

    heads, b = 12, 8
    h, width = heads * head_dim, built_head_dim(head_dim, fa.BWD_HEAD_DIMS)
    q, k, v, do = (_randn(gen, b, s, h, dtype=torch.bfloat16) for _ in range(4))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    got = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    padded = [pad_heads(t, heads, width) for t in (q, k, v, do)]
    grads = [torch.empty_like(padded[0]) for _ in range(3)]
    _k10_entry(*padded[:3], bias, padded[3], grads, heads, head_dim)
    for name, a, c in zip(("dq", "dk", "dv"), got, grads):
        assert torch.equal(a, unpad_heads(c, heads, head_dim)), name


K9_IN_PLACE_CASES = {  # B, S, pads, query heads, kv heads, head_dim, dtype
    "d100": (1, 4096, (1100,), 32, 32, 100, "bfloat16"),
    "d80": (1, 4096, (1100,), 32, 32, 80, "bfloat16"),
    "d96": (1, 4096, (1100,), 32, 32, 96, "bfloat16"),
    "d100_short": (2, 300, (0, 37), 8, 8, 100, "bfloat16"),
    "d80_group2": (1, 300, (11,), 8, 4, 80, "bfloat16"),
    "d96_group3": (1, 300, (0,), 12, 4, 96, "bfloat16"),
    "d80_group4": (2, 500, (0, 130), 8, 2, 80, "bfloat16"),
    "d96_group6": (1, 777, (5,), 12, 2, 96, "bfloat16"),
    "d72_group2": (1, 300, (64,), 4, 2, 72, "bfloat16"),
    "d104": (1, 300, (3,), 4, 4, 104, "bfloat16"),
    "d120_group2": (1, 257, (0,), 4, 2, 120, "bfloat16"),
    "d98_window": (1, 300, (9,), 8, 8, 98, "bfloat16"),
    "d102_window": (1, 300, (0,), 8, 8, 102, "bfloat16"),
    "f32_d100": (1, 128, (60,), 32, 32, 100, "float32"),
    "f32_d80_group4": (2, 128, (0, 60), 8, 2, 80, "float32"),
    "f32_d26_group2": (1, 200, (3,), 4, 2, 26, "float32"),
    "f32_d52_group7": (1, 300, (20,), 14, 2, 52, "float32"),
}


def _no_k9_pad_copies(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("K9 padded a head it reads in place")
    monkeypatch.setattr(cf, "pad_heads", refuse)
    monkeypatch.setattr(cf, "unpad_heads", refuse)


def _k9_inputs(gen, case):
    b, s, pads, hq, hkv, d, dtype = K9_IN_PLACE_CASES[case]
    q = _randn(gen, b, s, hq * d, dtype=DTYPES[dtype])
    k, v = (_randn(gen, b, s, hkv * d, dtype=DTYPES[dtype]) for _ in range(2))
    return q, k, v, torch.tensor(pads, dtype=torch.int32, device="cuda")


def _k9_entry(q, k, v, pad, out, hq: int, hkv: int, head_dim: int):
    """K9's C entry on q, k, v and out as they lie (a head's columns in
    memory = the tensors' width / heads)."""
    b, s, h = q.shape
    kernel_lib.launch("causal_flash_prefill", "frag_causal_flash", q.device,
                      *(kernel_lib.ptr(t) for t in (q, k, v, pad, out)), b, s, hq, hkv, h // hq,
                      kernel_lib.DTYPE_CODES[q.dtype], head_dim)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", list(K9_IN_PLACE_CASES))
def test_causal_flash_kernel_reads_heads_in_place(gen, monkeypatch, case):
    """K9 at heads of 80, 96 and 100 (open_llama_3b_v2) at the 4,096-token
    prompt and short rows, GQA groups 1 to 6, 72, 104 and 120 (4-D maps,
    products 80, 104 and 128 wide), 98 and 102 (windows at offsets up to
    6, products 104 and 128 wide), and f32 at 100, 80, 26 and 52: read
    where they lie (no pad copy, counted in IN_PLACE_LAUNCHES), real rows
    within 3e-2 (bf16)
    or 1e-4 (f32) of the plain version and each (position, head) row
    within 2^-6 or 1e-4 of its largest value, padding rows exactly 0, the
    same bits twice."""
    b, s, pads, hq, hkv, d, dtype = K9_IN_PLACE_CASES[case]
    assert cf.causal_reads_in_place(d, hq, hkv, DTYPES[dtype])
    _no_k9_pad_copies(monkeypatch)
    q, k, v, pad = _k9_inputs(gen, case)
    before = cf.IN_PLACE_LAUNCHES[d]
    out = _launches_once(cf, lambda: cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq,
                                                             num_kv_heads=hkv))
    assert cf.IN_PLACE_LAUNCHES[d] == before + 1
    ref = cf.causal_flash_prefill_plain(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    tol, rtol = (3e-2, 2.0 ** -6) if dtype == "bfloat16" else (1e-4, 1e-4)
    for row, p in enumerate(pads):
        assert torch.isfinite(out[row].float()).all()
        torch.testing.assert_close(out[row, p:].float(), ref[row, p:].float(), atol=tol, rtol=0)
        got, want = (t[row, p:].float().view(s - p, hq, d) for t in (out, ref))
        row_err = (got - want).abs().amax(dim=-1)
        assert (row_err <= rtol * want.abs().amax(dim=-1)).all(), row_err.max()
        assert (out[row, :p] == 0).all()
    assert torch.equal(out, cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq,
                                                     num_kv_heads=hkv))


K9_ISOLATION_CASES = ["d100_short", "d80_group2", "d96_group3", "d98_window", "d102_window",
                      "f32_d100"]


@pytest.mark.parametrize("case", K9_ISOLATION_CASES)
def test_causal_flash_in_place_heads_are_isolated(gen, case):
    """New random values in kv head g+1's columns of k and v and in its
    query heads' columns of q leave every other query head's output
    bit-identical; an inf in k's and v's columns of kv heads g-1 and g+1
    next to kv head g (inside its window at 100, 98 and 102) and a NaN in
    q's columns next to its query heads leave those heads bit-identical."""
    b, s, pads, hq, hkv, d, dtype = K9_IN_PLACE_CASES[case]
    group, g = hq // hkv, 1
    q, k, v, pad = _k9_inputs(gen, case)
    first = cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    kv_cols = slice((g + 1) * d, (g + 2) * d)
    q_cols = slice((g + 1) * group * d, (g + 2) * group * d)
    for t in (k, v):
        t[..., kv_cols] = _randn(gen, b, s, d, dtype=t.dtype, scale=4.0)
    q[..., q_cols] = _randn(gen, b, s, group * d, dtype=q.dtype, scale=4.0)
    second = cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    keep = torch.ones(hq * d, dtype=torch.bool, device="cuda")
    keep[q_cols] = False
    assert not torch.equal(first[..., q_cols], second[..., q_cols])
    assert torch.equal(first[..., keep], second[..., keep])
    for t in (k, v):
        t[0, -1, (g + 1) * d] = float("inf")
        t[0, -2, g * d - 1] = float("-inf")
    q[0, -1, (g + 1) * group * d] = float("nan")
    q[0, -1, g * group * d - 1] = float("nan")
    third = cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    heads = slice(g * group * d, (g + 1) * group * d)
    assert torch.equal(second[..., heads], third[..., heads])


@pytest.mark.parametrize("case", ["d100", "d80_group4", "d96_group6", "d98_window", "d102_window",
                                  "f32_d100", "f32_d26_group2"])
def test_causal_flash_in_place_writes_only_the_output(gen, case):
    """Into a NaN-filled out with a guard region after it, K9 in place
    (through its C entry) writes every element of out (padding rows as
    zeros, no NaN left) and nothing past it."""
    b, s, pads, hq, hkv, d, dtype = K9_IN_PLACE_CASES[case]
    q, k, v, pad = _k9_inputs(gen, case)
    guard, n = 4096, q.numel()
    buf = torch.full((n + guard,), float("nan"), dtype=q.dtype, device="cuda")
    buf[n:] = 7.0
    out = buf[:n].view(q.shape)
    _k9_entry(q, k, v, pad, out, hq, hkv, d)
    assert not torch.isnan(out.float()).any()
    assert (buf[n:] == 7.0).all()
    ref = cf.causal_flash_prefill_plain(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    for row, p in enumerate(pads):
        torch.testing.assert_close(out[row, p:].float(), ref[row, p:].float(), atol=tol, rtol=0)


@pytest.mark.parametrize("case", ["d80", "d96", "d80_group4", "d72_group2", "d104",
                                  "d120_group2", "f32_d80_group4", "f32_d52_group7"])
def test_causal_flash_in_place_is_the_padded_copy_to_the_bit(gen, case):
    """A head of whole 16-byte chunks read in place is the padded copy to
    the bit: at 80, 96, 72 and 104 the head-128 kernel's products at the
    head's width (80, 96, 80, 104, 128) leave out only zero columns, whose
    products add exact zeros, and f32 computes the same sums, so the
    output equals the C entry's on heads zero-padded
    to 64 or 128 (the padded columns dropped)."""
    from financial_rag_tpu_torch.ops.common import built_head_dim, pad_heads, unpad_heads

    b, s, pads, hq, hkv, d, dtype = K9_IN_PLACE_CASES[case]
    q, k, v, pad = _k9_inputs(gen, case)
    got = cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    width = built_head_dim(d, cf.KERNEL_HEAD_DIMS)
    qp = pad_heads(q, hq, width)
    kp, vp = pad_heads(k, hkv, width), pad_heads(v, hkv, width)
    out = torch.empty_like(qp)
    _k9_entry(qp, kp, vp, pad, out, hq, hkv, d)
    assert torch.equal(got, unpad_heads(out, hq, d))


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 100), (8, 8, 52), (14, 2, 48), (4, 4, 25),
                                      (3, 3, 100), (4, 4, 126)])
def test_causal_flash_copied_widths_match_plain(gen, monkeypatch, hq, hkv, d):
    """The widths K9's route rule sends to the padded copy in bf16 (a
    window with GQA groups above 1, heads narrower than 64 (52, 48), an
    odd head_dim, 126 whose window would not fit 128 columns, 100 over rows
    of partial 16-byte chunks) still
    match the plain version within 3e-2 through the pad copies; the C
    entry refuses them in place."""
    assert not cf.causal_reads_in_place(d, hq, hkv, torch.bfloat16)
    pads = []
    real_pad = cf.pad_heads
    monkeypatch.setattr(cf, "pad_heads", lambda *a: pads.append(a[2]) or real_pad(*a))
    b, s = 2, 200
    q = _randn(gen, b, s, hq * d, dtype=torch.bfloat16)
    k, v = (_randn(gen, b, s, hkv * d, dtype=torch.bfloat16) for _ in range(2))
    pad = torch.tensor([0, 30], dtype=torch.int32, device="cuda")
    out = cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    assert len(pads) == 3
    ref = cf.causal_flash_prefill_plain(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    for row, p in enumerate((0, 30)):
        torch.testing.assert_close(out[row, p:].float(), ref[row, p:].float(), atol=3e-2, rtol=0)
    with pytest.raises(RuntimeError):
        _k9_entry(q, k, v, pad, torch.empty_like(q), hq, hkv, d)


@pytest.mark.parametrize("h,i", [(312, 1200), (128, 512), (512, 2048), (1024, 4000)])
def test_fused_ffn_generic_route_under_every_plan(gen, h, i):
    """frag_fused_ffn_large at a query's 512 tokens under every plan the C
    entry takes (tile columns 64, 128 or 256 in each product, the second
    product split 1 to ceil(I / 64) // 4 ways, whether or not the split
    divides the k steps): within 3e-2 of the plain version."""
    from financial_rag_tpu_torch.scripts import k3_plans, kernel_ab

    lib = kernel_ab.build_library(kernel_lib.CSRC, kernel_lib.build_dir() / "k3_plan_test")
    for up, down, splits in k3_plans.plans(h, i):
        gen.manual_seed(1)
        run, (out,) = kernel_ab.k3_call(lib, 512, h, {"splits": splits, "cols": (up, down)},
                                        gen, i)
        run()
        x, w1, b1, w2, b2 = run.tensors[:5]
        torch.testing.assert_close(out.float(), ffn.fused_ffn_plain(x, w1, b1, w2, b2).float(),
                                   atol=3e-2, rtol=0, msg=lambda m: f"{(up, down, splits)}: {m}")


def _grid(gen, *shape):
    """Coordinates on a 1/64 grid: every score is exact in f32 whatever the
    summation order, so kernel and plain version must agree bit for bit."""
    return torch.randint(-3, 4, shape, generator=gen, device="cuda").float() / 64.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one_tile", "dead_slots", "all_dead", "ties", "uneven_groups"])
def test_packed_topk_kernel_matches_plain_exactly(gen, case, dtype):
    """uneven_groups: 13 tiles and 100 queries sweep in 7 tile groups, the
    last one short."""
    n = {"one_tile": 1024, "uneven_groups": 13 * 1024}.get(case, 4096)
    q, x = _grid(gen, 100 if case == "uneven_groups" else 5, 384), _grid(gen, n, 384)
    valid = torch.ones(n, device="cuda")
    if case == "dead_slots":
        valid[torch.randperm(n, generator=gen, device="cuda")[:1500]] = 0.0
    if case == "all_dead":
        valid.zero_()
    if case == "ties":
        x[1024:2048] = x[:1024]
        x[70] = x[5]
    x = x.to(DTYPES[dtype])
    out_s, out_i = _launches_once(topk, lambda: topk.packed_topk_fused(q, x, valid, 24),
                                  "packed_topk_fused")
    ref_s, ref_i = topk.packed_topk_fused_plain(q, x, valid, 24)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)
    if case == "all_dead":
        assert (out_i == -1).all()


@pytest.mark.parametrize("k", [1, 24, 256])
@pytest.mark.parametrize("n", [16, 1024, 4096, 102400])
@pytest.mark.parametrize("bq", [1, 8, 64, 65, 128, 129, 192, 384])
def test_packed_topk_kernel_shapes_exactly(gen, bq, n, k):
    """Exact-grid data with repeated rows and 5% dead rows at D = 384: query
    counts on both sides of the 64- and 128-query tiles (65 and 129 leave a
    warpgroup or a block with one live query), the micro-batcher's wave
    buckets (192 rows, 384 after an overshoot), one tile of 16 buckets (32
    candidates: at k = 256 the rest are empties), one and 4 tiles, the
    table's 100, and k from 1 to 256. Bit for bit the plain version."""
    q, x = _grid(gen, bq, 384), _grid(gen, n, 384)
    if n >= 2048:
        x[1024:2048] = x[:1024]
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.05).float()
    x = x.to(torch.bfloat16)
    out_s, out_i = _launches_once(topk, lambda: topk.packed_topk_fused(q, x, valid, k),
                                  "packed_topk_fused")
    ref_s, ref_i = topk.packed_topk_fused_plain(q, x, valid, k)
    assert out_s.shape == (bq, k) and out_i.shape == (bq, k)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


@pytest.mark.parametrize("d", [16, 48, 208])
def test_packed_topk_kernel_on_narrow_features(gen, d):
    """D below the sweep's 384 features: the corpus tiles' boxes past D
    (all of them past the first at D = 16 and 48) and the query chunks
    past D are zeros, so the products are those of D features; bit for bit
    the plain version on exact-grid data."""
    q, x = _grid(gen, 70, d), _grid(gen, 4096, d).to(torch.bfloat16)
    valid = (torch.rand(4096, generator=gen, device="cuda") > 0.05).float()
    out_s, out_i = _launches_once(topk, lambda: topk.packed_topk_fused(q, x, valid, 24),
                                  "packed_topk_fused")
    ref_s, ref_i = topk.packed_topk_fused_plain(q, x, valid, 24)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


def test_packed_topk_kernel_rejects_what_it_cannot_take(gen):
    q, x, valid = _grid(gen, 2, 1056), _grid(gen, 1024, 1056).bfloat16(), torch.ones(1024, device="cuda")
    with pytest.raises(ValueError, match="at most 1024"):
        topk.packed_topk_fused(q, x, valid, 24)
    with pytest.raises(ValueError, match=r"\[1, 256\]"):
        topk.packed_topk_fused(q[:, :384], x[:, :384].contiguous(), valid, 257)


def test_packed_topk_kernel_on_unit_vectors(gen):
    """Real-valued scores: the f32 dot order differs from the plain
    version's, so ids may swap only between scores within one quantum."""
    n = 8192
    x = _randn(gen, n, 384)
    x = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = _randn(gen, 70, 384)                          # 70 queries: padded to 128
    q = q / q.norm(dim=1, keepdim=True)
    valid = torch.ones(n, device="cuda")
    out_s, out_i = _launches_once(topk, lambda: topk.packed_topk_fused(q, x, valid, 24),
                                  "packed_topk_fused")
    ref_s, ref_i = topk.packed_topk_fused_plain(q, x, valid, 24)
    quantum = 2.0 ** (3 - 22)                         # 8 tiles -> bits = 3
    same = out_i == ref_i
    assert same.float().mean().item() >= 0.99
    assert (out_s - ref_s).abs().max().item() <= quantum + 1e-3


SWEEPS = {
    "bucketed_topk_fused": (topk.bucketed_topk_fused, topk.bucketed_topk_fused_plain),
    "bucketed_topk": (topk.bucketed_topk, topk.bucketed_topk_plain),
    "topk_matmul": (topk.topk_matmul, topk.topk_matmul_plain),
}


def _sweep_case(gen, case, dtype):
    """Exact-grid corpora (int8: integer rows with per-row weights): every
    score and tie is exact, so kernel and plain version agree bit for bit,
    empty slots included. uneven: 13 tiles and 100 queries, so the tile or
    round groups end short."""
    n = {"one_tile": 1024, "uneven": 13 * 1024}.get(case, 6144)
    q = _grid(gen, 100 if case == "uneven" else 5, 384)
    x = _grid(gen, n, 384)
    valid = torch.ones(n, device="cuda")
    if case == "dead_slots":
        valid[torch.randperm(n, generator=gen, device="cuda")[:2000]] = 0.0
    if case == "few_live":           # fewer live rows than k, in several tiles
        valid.zero_()
        valid[torch.tensor([3, 1500, 2100, 5000], device="cuda")] = 1.0
    if case == "all_dead":
        valid.zero_()
    if case == "ties":
        x[1024:2048] = x[:1024]
        x[4096 + 5] = x[5]
        x[70] = x[5]
    if dtype == "int8":
        x = (x * 64).to(torch.int8)
        valid = valid * 0.01
    return q, x.to(DTYPES[dtype]), valid


@pytest.mark.parametrize("name", list(SWEEPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["one_tile", "dead_slots", "few_live", "all_dead", "ties",
                                  "uneven"])
def test_sweep_kernels_match_plain_exactly(gen, name, dtype, case):
    kernel, plain = SWEEPS[name]
    q, x, valid = _sweep_case(gen, case, dtype)
    kw = {} if name == "topk_matmul" else {"nbuckets": 2048}
    out_s, out_i = _launches_once(topk, lambda: kernel(q, x, valid, 24, **kw), name)
    ref_s, ref_i = plain(q, x, valid, 24, **kw)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


@pytest.mark.parametrize("k", [1, 128])
def test_exact_sweep_list_lengths(gen, k):
    q, x, valid = _sweep_case(gen, "dead_slots", "bfloat16")
    out = _launches_once(topk, lambda: topk.topk_matmul(q, x, valid, k), "topk_matmul")
    ref = topk.topk_matmul_plain(q, x, valid, k)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_int8_sweeps_on_unit_vectors(gen):
    """Real-valued unit vectors, int8-quantized: the int32 dot is exact, so
    even here the kernels equal their plain versions bit for bit."""
    n = 8192
    v = _randn(gen, n, 384)
    v = v / v.norm(dim=1, keepdim=True)
    m = v.abs().amax(dim=1)
    x = torch.round(v * (127.0 / m[:, None])).clamp(-127, 127).to(torch.int8)
    valid = m / 127.0
    q = _randn(gen, 70, 384)
    for name, (kernel, plain) in SWEEPS.items():
        out = _launches_once(topk, lambda: kernel(q, x, valid, 24), name)
        ref = plain(q, x, valid, 24)
        assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0]), name


def _hopper_sweep_case(gen, bq, n, dtype, d=384):
    """Exact-grid queries and corpus with repeated rows (a tile repeated in
    the next, and one row in the next round of 4,096 buckets) and 5% dead
    rows; int8: integer rows with per-row weights. Every score and tie is
    exact, so a kernel and its plain version agree bit for bit."""
    q, x = _grid(gen, bq, d), _grid(gen, n, d)
    if n >= 2048:
        x[1024:2048] = x[:1024]
    if n > 4096:
        x[4096 + 7] = x[7]
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.05).float()
    if dtype == "int8":
        return q, (x * 64).to(torch.int8), valid * 0.01
    return q, x.to(DTYPES[dtype]), valid


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("k", [1, 24, 128, 256])
@pytest.mark.parametrize("n", [1024, 4096, 16384, 102400])
@pytest.mark.parametrize("bq", [1, 8, 64, 65, 128, 200])
def test_bucketed_fused_kernel_shapes_exactly(gen, bq, n, k, dtype):
    """K5's Hopper sweep and extract at D = 384: query counts on both sides
    of the 64- and 128-query tiles (65 and 200 leave a warpgroup with one or
    eight live queries), one round of 1,024 buckets, one round of 4,096, 4
    and 25 rounds, k from 1 to 256 (at N = 1,024, 256 of 1,024 buckets).
    Bit for bit the plain version."""
    q, x, valid = _hopper_sweep_case(gen, bq, n, dtype)
    out_s, out_i = _launches_once(topk, lambda: topk.bucketed_topk_fused(q, x, valid, k),
                                  "bucketed_topk_fused")
    ref_s, ref_i = topk.bucketed_topk_fused_plain(q, x, valid, k)
    assert out_s.shape == (bq, k) and out_i.shape == (bq, k)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("k", [1, 24, 128, 256])
@pytest.mark.parametrize("n", [1024, 4096, 16384, 102400])
@pytest.mark.parametrize("bq", [1, 8, 64, 65, 128, 200])
def test_bucketed_topk_kernel_shapes_exactly(gen, bq, n, k, dtype):
    """K7 on the Hopper sweep and its write kernel, then the wrapper's
    stable top k, over K5's shapes at D = 384. Bit for bit the plain
    version, empty slots (NEG, -1) included."""
    q, x, valid = _hopper_sweep_case(gen, bq, n, dtype)
    out_s, out_i = _launches_once(topk, lambda: topk.bucketed_topk(q, x, valid, k),
                                  "bucketed_topk")
    ref_s, ref_i = topk.bucketed_topk_plain(q, x, valid, k)
    assert out_s.shape == (bq, k) and out_i.shape == (bq, k)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("bq,n,nbuckets,k", [(65, 4096, 1024, 512), (128, 102400, 8192, 24),
                                             (9, 102400, 8192, 1000)])
def test_bucketed_topk_kernel_beyond_the_extract(gen, bq, n, nbuckets, k, dtype):
    """Shapes only K7 takes (K5's extract holds k <= 256 of at most 4,096
    buckets): k = 512 of 1,024 buckets, and 8,192 buckets over 102,400 rows
    (12.5 rounds: the last round reaches half the buckets). Bit for bit the
    plain version."""
    q, x, valid = _hopper_sweep_case(gen, bq, n, dtype)
    out = _launches_once(topk, lambda: topk.bucketed_topk(q, x, valid, k, nbuckets=nbuckets),
                         "bucketed_topk")
    ref = topk.bucketed_topk_plain(q, x, valid, k, nbuckets=nbuckets)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_bucketed_topk_kernel_runs_the_hopper_sweep(gen, dtype):
    """The profiler sees K7 launch bucketed_wgmma_sweep_kernel and its
    write kernel, and never the older bucketed_sweep_kernel."""
    from torch.profiler import ProfilerActivity, profile

    q, x, valid = _hopper_sweep_case(gen, 9, 4096, dtype)
    topk.bucketed_topk(q, x, valid, 24)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        topk.bucketed_topk(q, x, valid, 24)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert any("bucketed_wgmma_sweep_kernel" in n for n in names), names
    assert any("bucketed_write_kernel" in n for n in names), names
    assert not any("bucketed_sweep_kernel" in n for n in names), names


def test_bucketed_topk_kernel_rejects_what_the_hopper_sweep_cannot_take(gen):
    """K7 raises where its int8 / bf16 sweep cannot take a shape, and does
    not take the older sweep instead."""
    valid = torch.ones(1024, device="cuda")
    q, x = _grid(gen, 2, 1056), _grid(gen, 1024, 1056).bfloat16()
    with pytest.raises(ValueError, match="above the int8/bf16 sweep's 1024"):
        topk.bucketed_topk(q, x, valid, 24)
    q, x = q[:, :384].contiguous(), x[:, :384].contiguous()
    with pytest.raises(ValueError, match="multiples of 32"):   # 48 buckets
        topk.bucketed_topk(q, x, valid, 24, nbuckets=48, block_n=16)
    x1040, v1040 = _grid(gen, 1040, 384).bfloat16(), torch.ones(1040, device="cuda")
    with pytest.raises(ValueError, match="multiples of 32"):   # N = 1,040
        topk.bucketed_topk(q, x1040, v1040, 24, nbuckets=1040, block_n=16)
    buf = torch.zeros(1024 * 384 + 8, dtype=torch.bfloat16, device="cuda")
    unaligned = buf[4:4 + 1024 * 384].view(1024, 384)          # 8 bytes past a boundary
    unaligned.copy_(x)
    with pytest.raises(ValueError, match="16-byte boundary"):
        topk.bucketed_topk(q, unaligned, valid, 24)
    with pytest.raises(ValueError, match=r"\[1, nbuckets\]"):
        topk.bucketed_topk(q, x, valid, 1025)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("k", [1, 24, 128])
@pytest.mark.parametrize("n", [1024, 4096, 16384, 102400])
@pytest.mark.parametrize("bq", [1, 8, 64, 65, 128, 200])
def test_exact_kernel_shapes_exactly(gen, bq, n, k, dtype):
    """K6's Hopper sweep and chunked merge at D = 384 over the same shapes
    (at k = 128 and Bq = 1 the merge takes 16,384 candidates in 4 chunks).
    Bit for bit the plain version."""
    q, x, valid = _hopper_sweep_case(gen, bq, n, dtype)
    out_s, out_i = _launches_once(topk, lambda: topk.topk_matmul(q, x, valid, k), "topk_matmul")
    ref_s, ref_i = topk.topk_matmul_plain(q, x, valid, k)
    assert out_s.shape == (bq, k) and out_i.shape == (bq, k)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_s, ref_s)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 384])
@pytest.mark.parametrize("name", ["bucketed_topk_fused", "topk_matmul"])
def test_hopper_sweeps_on_narrow_features(gen, name, d, dtype):
    """D below the sweeps' 384 features: the corpus boxes and query chunks
    past D are zeros. Bit for bit the plain version."""
    kernel, plain = SWEEPS[name]
    q, x, valid = _hopper_sweep_case(gen, 70, 16384, dtype, d=d)
    out = _launches_once(topk, lambda: kernel(q, x, valid, 24), name)
    ref = plain(q, x, valid, 24)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("name", ["bucketed_topk_fused", "topk_matmul"])
def test_hopper_sweeps_on_a_few_live_rows(gen, name, dtype):
    """Fewer live rows than k, one of them in the last 1,024-row tile and
    one in bucket 0's column: K5's empty slots hold bucket 0's column, K6's
    the best live row outside the last tile. Bit for bit the plain version,
    run twice with the same bits."""
    kernel, plain = SWEEPS[name]
    q, x, valid = _hopper_sweep_case(gen, 65, 16384, dtype)
    live = torch.zeros_like(valid)
    live[torch.tensor([0, 900, 5000, 9001, 16000], device="cuda")] = 1.0
    valid = valid.clamp(min=0.01) * live
    out = _launches_once(topk, lambda: kernel(q, x, valid, 24), name)
    again = kernel(q, x, valid, 24)
    ref = plain(q, x, valid, 24)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])
    assert torch.equal(again[1], out[1]) and torch.equal(again[0], out[0])
    assert (out[0][:, 5:] == topk.NEG).all()


@pytest.mark.parametrize("k", [1, 24, 128])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_exact_kernel_when_every_tile_beats_the_last(gen, dtype, k):
    """The filter's worst case: every row's score is the largest so far (row
    j scores j for every query), so every key passes the threshold and a row
    flushes its buffer every few tiles (every 3-4 at k = 128); 3% dead rows.
    Bit for bit the plain version, and the same bits again."""
    n = 16384
    j = torch.arange(n, device="cuda")[:, None]
    f = torch.arange(384, device="cuda")[None, :]
    x = (j - 127 * f).clamp(0, 127).float()          # row j sums to j
    q = torch.ones(70, 384, device="cuda")
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.03).float()
    if dtype == "int8":
        x, valid = x.to(torch.int8), valid * 0.01
    else:
        x = (x / 64.0).to(torch.bfloat16)
    out = _launches_once(topk, lambda: topk.topk_matmul(q, x, valid, k), "topk_matmul")
    again = topk.topk_matmul(q, x, valid, k)
    ref = topk.topk_matmul_plain(q, x, valid, k)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[0], ref[0])
    assert torch.equal(again[1], out[1]) and torch.equal(again[0], out[0])
    assert (out[1][:, 0] > n - 64).all()


def test_hopper_sweeps_reject_what_they_cannot_take(gen):
    """K5 takes D <= 1,024, K6 D <= 384; k and D's multiple as before."""
    q, x = _grid(gen, 2, 1056), (_grid(gen, 1024, 1056) * 64).to(torch.int8)
    valid = torch.ones(1024, device="cuda")
    with pytest.raises(ValueError, match="above the int8/bf16 sweep's 1024"):
        topk.bucketed_topk_fused(q, x, valid, 24)
    with pytest.raises(ValueError, match="above the int8/bf16 sweep's 384"):
        topk.topk_matmul(q[:, :512].contiguous(), x[:, :512].contiguous(), valid, 24)
    x = x[:, :384].contiguous()
    with pytest.raises(ValueError, match=r"\[1, 128\]"):
        topk.topk_matmul(q[:, :384], x, valid, 129)
    with pytest.raises(ValueError, match=r"\[1, 256\]"):
        topk.bucketed_topk_fused(q[:, :384], x, valid, 257)
    with pytest.raises(ValueError, match="32 for int8"):
        topk.bucketed_topk_fused(q[:, :48].contiguous(), x[:, :48].contiguous(), valid, 24)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_probe_kernel_matches_plain(gen, dtype):
    nlist, L, B, P = 16, 128, 9, 5
    if dtype == "int8":
        storage = torch.randint(-127, 128, (nlist, L, 384), generator=gen, device="cuda").to(torch.int8)
        q = torch.randint(-127, 128, (B, 384), generator=gen, device="cuda").to(torch.int8)
        weights = torch.full((nlist, L), 1.0 / 127.0, device="cuda")
    else:
        storage = _randn(gen, nlist, L, 384, scale=384 ** -0.5).to(DTYPES[dtype])
        q = _randn(gen, B, 384, scale=384 ** -0.5).to(DTYPES[dtype])
        weights = torch.ones(nlist, L, device="cuda")
    weights[:, 100:] = 0.0                              # empty slots
    probes = torch.randint(0, nlist, (B, P), generator=gen, device="cuda", dtype=torch.int32)
    out = _launches_once(ivf_probe, lambda: ivf_probe.probe_scores(q, storage, weights, probes))
    ref = ivf_probe.probe_scores_plain(q, storage, weights, probes)
    assert out.shape == (B, P, L)
    if dtype == "int8":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert (out[:, :, 100:] == -1.0e5).all()


@pytest.mark.parametrize("backend,dtype", [("pallas_fused", torch.int8),
                                           ("pallas_bucketed", torch.bfloat16),
                                           ("pallas_exact", torch.bfloat16),
                                           ("pallas_exact", torch.int8)])
def test_flat_index_backends_on_cuda_match_the_cpu(gen, backend, dtype):
    x = _grid(gen, 3000, 384).cpu().numpy()
    ids = list(range(1, 3001))
    q = _grid(gen, 4, 384).cpu().numpy()
    gpu = FlatIndex(dim=384, dtype=dtype, backend=backend, device="cuda")
    cpu = FlatIndex(dim=384, dtype=dtype, backend=backend, device="cpu")
    for idx in (gpu, cpu):
        idx.upsert(ids, x)
        idx.delete(ids[::5])
    name = {"pallas_fused": "bucketed_topk_fused", "pallas_bucketed": "bucketed_topk",
            "pallas_exact": "topk_matmul"}[backend]
    got = _launches_once(topk, lambda: gpu.search(q, 24), name)
    want = cpu.search(q, 24)
    assert (got[0] == want[0]).all()


def test_ivf_index_on_cuda_launches_the_probe_and_matches_the_cpu(gen):
    x = _randn(gen, 2000, 384).cpu().numpy()
    gpu = IVFIndex(dim=384, nlist=16, list_size=256, nprobe=4, device="cuda")
    cpu = IVFIndex(dim=384, nlist=16, list_size=256, nprobe=4, device="cpu")
    gpu.train(x, iters=4)
    cpu.centroids = gpu.centroids.cpu()
    for idx in (gpu, cpu):
        idx.upsert(list(range(1, 2001)), x)
    q = x[:3]
    got = _launches_once(ivf_probe, lambda: gpu.search(q, 10))
    want = cpu.search(q, 10)
    assert (got[0][:, 0] == [1, 2, 3]).all()
    assert (got[0] == want[0]).mean() >= 0.9   # bf16 sums in another order


CAUSAL_CASES = {   # B, S, pads, query heads, kv heads, head_dim, dtype
    "ragged": (2, 100, (0, 37), 14, 2, 64, "bfloat16"),
    "pad_is_last_row": (1, 256, (255,), 14, 2, 64, "bfloat16"),
    "mixed_pads_d128": (3, 300, (0, 64, 299), 14, 2, 128, "bfloat16"),
    "group1": (2, 200, (5, 130), 4, 4, 64, "bfloat16"),
    "group1_d128": (1, 129, (1,), 8, 8, 128, "bfloat16"),
    "padding_tiles": (1, 300, (200,), 14, 2, 64, "bfloat16"),
    "pad_inside_packed_tile": (1, 300, (20,), 14, 2, 64, "bfloat16"),
    "s4096_d128": (1, 4096, (1100,), 14, 2, 128, "bfloat16"),
    "one_row": (1, 1, (0,), 14, 2, 64, "bfloat16"),
    "f32_d64": (2, 190, (0, 77), 14, 2, 64, "float32"),
    "f32_d128": (1, 70, (3,), 4, 2, 128, "float32"),
    "group6_pad_inside_packed_rows_d128": (1, 500, (130,), 12, 2, 128, "bfloat16"),
    "group4_ragged_d128": (1, 777, (0,), 8, 2, 128, "bfloat16"),
    "group7_ragged_d128": (1, 1111, (5,), 7, 1, 128, "bfloat16"),
    "pad_is_last_row_d128": (1, 300, (299,), 4, 1, 128, "bfloat16"),
    "mixed_pads_b3_d128": (3, 1024, (0, 300, 1023), 12, 2, 128, "bfloat16"),
    # narrower heads: 100 (open_llama_3b_v2), 80 and 96 at the head-128 kernel, 32 at the head-64 one
    "s4096_d100": (1, 4096, (1100,), 32, 32, 100, "bfloat16"),
    "s4096_d80": (1, 4096, (1100,), 32, 32, 80, "bfloat16"),
    "s4096_d96": (1, 4096, (1100,), 32, 32, 96, "bfloat16"),
    "f32_d100": (1, 128, (60,), 32, 32, 100, "float32"),
    "f32_d80_group4": (2, 128, (0, 60), 8, 2, 80, "float32"),
    "mixed_pads_d32": (3, 300, (0, 64, 299), 14, 2, 32, "bfloat16"),
}


@pytest.mark.parametrize("case", list(CAUSAL_CASES))
def test_causal_flash_kernel_matches_plain(gen, case):
    """Real rows within 3e-2 (bf16) or 1e-4 (f32) of the plain version, and
    each (position, head) row within 2^-6 (bf16, two ulps of its largest
    value) or 1e-4 (f32) of its own largest value: rows that attend many
    random keys have outputs far below 1. Padding rows exactly 0. Covers S
    not a multiple of the 64-row tiles, a pad of S-1, tiles made only of
    padding rows, a pad that ends inside a block's 128 packed (position,
    head) rows (18 positions of a 7-head group), GQA groups of 1 and 7,
    head_dim 64 and 128, and the 4,096-token prompt at head_dim 128. At
    head_dim 128 (its own kernel: 128-key tiles by TMA) also groups 4, 6
    and 7 at S not a multiple of 128, a group-6 pad that ends inside a
    block's packed rows (position 130 is packed row 780 of block 6), a pad
    of S-1, and B=3 with mixed pads. Narrower heads, read in place since
    they were first padded in a copy: 100, 80 and 96 (at the head-128
    kernel) at the 4,096-token prompt and in f32, 32 (at the head-64
    kernel)."""
    b, s, pads, hq, hkv, d, dtype = CAUSAL_CASES[case]
    d_before = cf.HEAD_DIM_LAUNCHES[d]
    q = _randn(gen, b, s, hq * d, dtype=DTYPES[dtype])
    k, v = (_randn(gen, b, s, hkv * d, dtype=DTYPES[dtype]) for _ in range(2))
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
    out = _launches_once(cf, lambda: cf.causal_flash_prefill(q, k, v, pad, num_q_heads=hq,
                                                             num_kv_heads=hkv))
    ref = cf.causal_flash_prefill_plain(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert cf.HEAD_DIM_LAUNCHES[d] == d_before + 1
    tol, rtol = (3e-2, 2.0 ** -6) if dtype == "bfloat16" else (1e-4, 1e-4)
    for row, p in enumerate(pads):
        assert torch.isfinite(out[row].float()).all()
        torch.testing.assert_close(out[row, p:].float(), ref[row, p:].float(), atol=tol, rtol=0)
        got, want = (t[row, p:].float().view(s - p, hq, d) for t in (out, ref))
        row_err = (got - want).abs().amax(dim=-1)
        assert (row_err <= rtol * want.abs().amax(dim=-1)).all(), row_err.max()
        assert (out[row, :p] == 0).all()


def test_causal_flash_kernel_rejects_what_it_cannot_take(gen):
    """Heads above 128 (160 here), q, k and v of two dtypes, a
    non-contiguous input: raised before any launch."""
    q = _randn(gen, 1, 64, 4 * 160, dtype=torch.bfloat16)
    kv = _randn(gen, 1, 64, 2 * 160, dtype=torch.bfloat16)
    pad = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match=r"\(K9\) takes head_dim <= 128"):
        cf.causal_flash_prefill(q, kv, kv, pad, num_q_heads=4, num_kv_heads=2)
    q = _randn(gen, 1, 64, 14 * 64, dtype=torch.bfloat16)
    kv = _randn(gen, 1, 64, 2 * 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        cf.causal_flash_prefill(q, kv.float(), kv, pad, num_q_heads=14, num_kv_heads=2)
    wide = _randn(gen, 1, 64, 4 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        cf.causal_flash_prefill(q, kv, wide[..., :128], pad, num_q_heads=14, num_kv_heads=2)


def test_decoder_prefill_launches_k9_per_layer_and_matches_the_cpu(gen):
    """A 3-layer decoder with head_dim 64 (GQA 2:1) in bf16 on the card
    against the same weights in f32 on the CPU: one K9 launch per layer;
    last-position logits of a left-padded batch agree to cosine 0.999."""
    cfg = decoder.DecoderConfig(vocab_size=512, num_layers=3, hidden_size=256, num_heads=4,
                                num_kv_heads=2, intermediate_size=512, attention_bias=True,
                                eos_token_id=0)
    cpu = decoder.random_decoder_params(cfg, seed=1, device="cpu")
    gpu = decoder.random_decoder_params(cfg, seed=1, dtype=torch.bfloat16, device="cuda")
    ids = torch.randint(1, 512, (2, 130), generator=gen, device="cuda")
    mask = torch.ones(2, 130, dtype=torch.int32, device="cuda")
    mask[1, :50] = 0
    before = cf.LAUNCHES
    got = decoder._prefill(gpu, ids, mask, 140, cfg)[0].float().cpu()
    torch.cuda.synchronize()
    assert cf.LAUNCHES == before + cfg.num_layers
    want = decoder._prefill(cpu, ids.cpu(), mask.cpu(), 140, cfg)[0]
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert (cos >= 0.999).all(), cos


# ------------------------------------------------------- training (K10, grads)


def _row_rel_err(got, want, heads):
    """Largest max|got - want| over one (position, head) row, as a share of
    that row's largest |want| (rows of zeros must match exactly)."""
    got, want = (t.float().reshape(-1, heads, t.shape[-1] // heads) for t in (got, want))
    err = (got - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1)
    return torch.where(err == 0, torch.zeros_like(err), err / scale.clamp_min(1e-30)).max().item()


BWD_CASES = {  # B, S, heads, head_dim
    "s128": (4, 128, 12, 32), "s512": (3, 512, 12, 32), "s200": (3, 200, 12, 32),
    "s1": (3, 1, 12, 32), "s129": (3, 129, 12, 32), "s256": (3, 256, 12, 32),
    "s257": (3, 257, 12, 32), "s128_6heads": (4, 128, 6, 32), "s128_3heads": (4, 128, 3, 32),
    "d64_s128": (4, 128, 12, 64), "d64_s512": (3, 512, 12, 64), "d64_s100": (3, 100, 12, 64),
    "d64_s64": (3, 64, 12, 64), "d64_s1": (3, 1, 12, 64), "d64_s129": (3, 129, 12, 64),
    "d64_s257": (3, 257, 12, 64), "d64_s128_6heads": (4, 128, 6, 64),
    "d64_s128_3heads": (4, 128, 3, 64)}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_attention_bwd_kernel_matches_plain(gen, case):
    """K10 against its plain version on the same bf16 inputs: dq, dk and dv
    each within 2^-6 of every (position, head) row's largest value (two
    bf16 ulps). Row 1 is padded, the last row fully masked (uniform P over
    the real keys); S = 200, 129, 257 and 1 leave tiles part-filled. S = 128
    is the longest row the dQ kernel walks once (its key tiles held in
    registers), S = 129 the shortest it walks twice; 6 and 3 heads are K11's
    local widths; at heads of 32 and of 64 (the bge-base width, 128-byte
    swizzled rows). Masked keys get exactly zero dk and dv."""
    b, s, heads, hd = BWD_CASES[case]
    q, k, v, do = (_randn(gen, b, s, hd * heads, dtype=torch.bfloat16) for _ in range(4))
    mask = _mask(b, s)
    bias = torch.where(mask > 0, 0.0, -1e9).float()
    before = fa.BWD_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, bias, do, num_heads=heads)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert torch.isfinite(g.float()).all(), name
        assert _row_rel_err(g, w, heads) <= 2.0 ** -6, (name, _row_rel_err(g, w, heads))
    if s > 3:
        assert (got[1][1, s // 3:] == 0).all() and (got[2][1, s // 3:] == 0).all()


@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("s", [128, 512])
def test_flash_attention_bwd_kernel_is_bit_identical_run_to_run(gen, s, head_dim):
    """K10 uses no atomics and no order that depends on scheduling: two
    launches on the same inputs give the same bits (one-pass and two-walk
    dQ kernels, at heads of 32 and of 64)."""
    q, k, v, do = (_randn(gen, 8, s, 12 * head_dim, dtype=torch.bfloat16) for _ in range(4))
    bias = torch.where(_mask(8, s) > 0, 0.0, -1e9).float()
    first = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=12)
    second = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=12)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("heads", [12, 6, 3])
@pytest.mark.parametrize("s", [1, 64, 65, 100, 128])
def test_flash_attention_bwd_fused_kernel(gen, s, heads):
    """K10's fused kernel (head_dim 64, S <= 128; at 12 heads and at K11's
    local 6 and 3): row 1 padded, row 2 with at most 64 live keys (its key
    tile 1 dead from S = 65 on), the last row fully masked. dq, dk and dv
    within 2^-6 of every (position, head) row's largest value of the plain
    version; dead keys' dk and dv exactly zero; the fully masked row's dv
    the mean of dO over its keys (uniform P); the same bits twice."""
    b = 4
    assert fa.bwd_launch_plan(s, 64)[0] == "fused"
    q, k, v, do = (_randn(gen, b, s, heads * 64, dtype=torch.bfloat16) for _ in range(4))
    mask = _mask(b, s)
    mask[2, 64:] = 0
    bias = torch.where(mask > 0, 0.0, -1e9).float()
    got = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    again = fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, bias, do, num_heads=heads)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.isfinite(g.float()).all(), name
        assert _row_rel_err(g, w, heads) <= 2.0 ** -6, (name, _row_rel_err(g, w, heads))
        assert torch.equal(g, a), name
    dead = (mask == 0) & (mask.sum(dim=1, keepdim=True) > 0)   # a fully masked row's keys all count
    assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()
    mean_do = do[-1].float().mean(0)
    torch.testing.assert_close(got[2][-1].float(), mean_do.expand(s, -1), atol=2e-2, rtol=0)


@pytest.mark.parametrize("s", [128, 100, 512, 300])
def test_flash_attention_bwd_kernel_at_head_dim_64_skips_dead_key_tiles_exactly(gen, s):
    """The dead-key argument of K10 at head_dim 64, through the fused kernel
    (S = 128, 100) and the two kernels (S = 512, 300): padding at -1e9 (dead
    key tiles skipped: never loaded by the dQ walk or the fused kernel, zeros
    written by the dK/dV kernel) and at -3e4 (every tile walked, each such
    probability exactly 0) give the same bits, trailing and leading padding
    alike; both within 2^-6 per row of the plain version."""
    b, heads = 6, 12
    q, k, v, do = (_randn(gen, b, s, heads * 64, dtype=torch.bfloat16) for _ in range(4))
    pos = torch.arange(s, device="cuda")[None, :]
    lo = torch.tensor([0, 0, 0, s // 2, s - 1, 0], device="cuda")[:, None]
    hi = torch.tensor([s, 1, 64, s, s, 65], device="cuda")[:, None]
    live = (pos >= lo) & (pos < hi)
    skip = fa.flash_attention_bwd(q, k, v, torch.where(live, 0.0, -1e9).float(), do, num_heads=heads)
    walk = fa.flash_attention_bwd(q, k, v, torch.where(live, 0.0, -3e4).float(), do, num_heads=heads)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, torch.where(live, 0.0, -1e9).float(), do,
                                        num_heads=heads)
    for name, a, w, g in zip(("dq", "dk", "dv"), skip, walk, want):
        assert torch.equal(a, w), name
        assert _row_rel_err(a, g, heads) <= 2.0 ** -6, (name, _row_rel_err(a, g, heads))
    assert (skip[1][~live] == 0).all() and (skip[2][~live] == 0).all()


@pytest.mark.parametrize("head_dim", [32, 16, 26])
@pytest.mark.parametrize("s", [512, 300])
def test_flash_attention_bwd_kernel_at_32_skips_dead_key_tiles_exactly(gen, s, head_dim):
    """The dead-key argument of K10's 32-wide two kernels above S = 128
    (where the dQ kernel walks a row twice), at heads of 32 and read in
    place at 16 and 26: padding at -1e9 (dead key tiles never loaded by
    the dQ walk, zeros written by the dK/dV kernel) and at -3e4 (every tile
    walked, each such probability exactly 0) give the same bits, trailing
    and leading padding alike; both within 2^-6 per row of the plain
    version."""
    b, heads = 6, 12
    q, k, v, do = (_randn(gen, b, s, heads * head_dim, dtype=torch.bfloat16) for _ in range(4))
    pos = torch.arange(s, device="cuda")[None, :]
    lo = torch.tensor([0, 0, 0, s // 2, s - 1, 0], device="cuda")[:, None]
    hi = torch.tensor([s, 1, 64, s, s, 65], device="cuda")[:, None]
    live = (pos >= lo) & (pos < hi)
    skip = fa.flash_attention_bwd(q, k, v, torch.where(live, 0.0, -1e9).float(), do, num_heads=heads)
    walk = fa.flash_attention_bwd(q, k, v, torch.where(live, 0.0, -3e4).float(), do, num_heads=heads)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, torch.where(live, 0.0, -1e9).float(), do,
                                        num_heads=heads)
    for name, a, w, g in zip(("dq", "dk", "dv"), skip, walk, want):
        assert torch.equal(a, w), name
        assert _row_rel_err(a, g, heads) <= 2.0 ** -6, (name, _row_rel_err(a, g, heads))
    assert (skip[1][~live] == 0).all() and (skip[2][~live] == 0).all()


def test_attention_and_ffn_gradients_on_cuda_match_the_cpu(gen):
    """Autograd through the Functions on the card (K2 + K10, K3 + its f32
    backward) against the same bf16 tensors and f32 weights on the CPU
    (the plain versions, same rounding points): attention grads per row
    within 2^-6; the FFN's f32 weight grads within 1e-4 of their largest
    value, dx within one bf16 ulp of its largest value."""
    b, s = 3, 100
    q, k, v = (_randn(gen, b, s, 384, dtype=torch.bfloat16).requires_grad_() for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    w = _randn(gen, b, s, 384)
    f_before, b_before = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = fa.flash_attention(q, k, v, bias, num_heads=12)
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (f_before + 1, b_before + 1)
    cq, ck, cv = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    cout = fa.flash_attention(cq, ck, cv, bias.cpu(), num_heads=12)
    want = torch.autograd.grad((cout.float() * w.cpu()).sum(), (cq, ck, cv))
    for g, wt in zip(got, want):
        assert _row_rel_err(g.cpu(), wt, 12) <= 2.0 ** -6

    x = _randn(gen, b, s, 384, dtype=torch.bfloat16).requires_grad_()
    ws = [_randn(gen, 384, 1536, scale=384 ** -0.5), _randn(gen, 1536, scale=0.1),
          _randn(gen, 1536, 384, scale=1536 ** -0.5), _randn(gen, 384, scale=0.1)]
    ws = [t.requires_grad_() for t in ws]
    f_before = ffn.LAUNCHES
    y = ffn.fused_ffn(x, *ws)
    got = torch.autograd.grad((y.float() * w).sum(), (x, *ws))
    torch.cuda.synchronize()
    assert ffn.LAUNCHES == f_before + 1
    cx, *cws = (t.detach().cpu().requires_grad_() for t in (x, *ws))
    cy = ffn.fused_ffn(cx, *cws)
    want = torch.autograd.grad((cy.float() * w.cpu()).sum(), (cx, *cws))
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    scale = want[0].float().abs().max()
    assert (got[0].float().cpu() - want[0].float()).abs().max() <= 2.0 ** -8 * scale
    for g, wt in zip(got[1:], want[1:]):
        assert (g.cpu() - wt).abs().max() <= 1e-4 * wt.abs().max()


def test_flash_attention_function_at_head_dim_64_matches_the_cpu(gen):
    """Autograd through FlashAttention at 12 heads of 64 on the card (K2 and
    K10 at 64, one launch each) against the same bf16 tensors on the CPU
    (the plain versions): the output and each gradient per (position, head)
    row within 2^-6 of its largest value."""
    b, s = 3, 100
    q, k, v = (_randn(gen, b, s, 768, dtype=torch.bfloat16).requires_grad_() for _ in range(3))
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    w = _randn(gen, b, s, 768)
    f_before, b_before = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = fa.flash_attention(q, k, v, bias, num_heads=12)
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (f_before + 1, b_before + 1)
    cq, ck, cv = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    cout = fa.flash_attention(cq, ck, cv, bias.cpu(), num_heads=12)
    want = torch.autograd.grad((cout.float() * w.cpu()).sum(), (cq, ck, cv))
    assert _row_rel_err(out.detach().cpu(), cout.detach(), 12) <= 2.0 ** -6
    for g, wt in zip(got, want):
        assert _row_rel_err(g.cpu(), wt, 12) <= 2.0 ** -6


def test_kernels_without_backward_raise_on_inputs_that_need_a_gradient(gen):
    """K1, K4 and K9 have no backward: with grad enabled and an input that
    requires a gradient they raise instead of cutting the graph; under
    no_grad they run."""
    hidden = _randn(gen, 2, 64, 384, dtype=torch.bfloat16).requires_grad_()
    mask = torch.ones(2, 64, dtype=torch.int32, device="cuda")
    corpus = _randn(gen, 1024, 384, dtype=torch.bfloat16)
    queries = _randn(gen, 4, 384, dtype=torch.bfloat16).requires_grad_()
    valid = torch.ones(1024, device="cuda")
    q = _randn(gen, 1, 64, 14 * 64, dtype=torch.bfloat16).requires_grad_()
    kv = _randn(gen, 1, 64, 2 * 64, dtype=torch.bfloat16)
    pad = torch.zeros(1, dtype=torch.int32, device="cuda")
    calls = [lambda: pn.masked_mean_l2_normalize(hidden, mask),
             lambda: topk.packed_topk_fused(queries, corpus, valid, 8),
             lambda: cf.causal_flash_prefill(q, kv, kv, pad, num_q_heads=14, num_kv_heads=2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def test_contrastive_step_on_cuda_matches_the_cpu(gen):
    """One contrastive step's loss and gradients: 2 layers at hidden 384 in
    bf16 on the card (K2, K10, K3; 4 launches each, K1 none) against f32 on
    the CPU, padded batch. Loss within 2e-2; each leaf group's gradient
    cosine >= 0.99 (bf16 activations; chip_smoke.py holds the full-depth
    step to bars set from readings and controls)."""
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.training import make_train_step

    cfg = ModelConfig(name="t", hidden_size=384, num_layers=2, num_heads=12,
                      intermediate_size=1536, vocab_size=30522, max_position=128)
    g = torch.Generator().manual_seed(0)
    ids = {k: torch.randint(5, 30000, (4, 40), generator=g) for k in ("q_ids", "d_ids")}
    masks = {k: (torch.arange(40)[None, :] < torch.tensor([40, 30, 12, 5])[:, None]).int()
             for k in ("q_mask", "d_mask")}
    batch = {**ids, **masks}
    params = random_params(cfg, seed=0)
    card, _ = make_train_step(cfg, device="cuda")
    cpu, _ = make_train_step(cfg, device="cpu")
    counts = {m: m.LAUNCHES for m in (fa, ffn, pn)}
    b_before = fa.BWD_LAUNCHES
    loss, grads = card.value_and_grad(
        {gk: {k: t.cuda().requires_grad_() for k, t in gv.items()} for gk, gv in params.items()},
        batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES - counts[fa] == 4 and ffn.LAUNCHES - counts[ffn] == 4
    assert fa.BWD_LAUNCHES - b_before == 4 and pn.LAUNCHES == counts[pn]
    want_loss, want = cpu.value_and_grad(
        {gk: {k: t.clone().requires_grad_() for k, t in gv.items()} for gk, gv in params.items()},
        batch)
    assert abs(float(loss) - float(want_loss)) <= 2e-2
    for group in ("embeddings", "layers"):
        for name in grads[group]:
            a, b_ = grads[group][name].float().cpu().flatten(), want[group][name].flatten()
            if b_.abs().max() == 0 or name == "k_b":   # k_b's gradient is 0 up to rounding
                continue
            cos = torch.nn.functional.cosine_similarity(a, b_, dim=0)
            assert cos >= 0.99, (group, name, float(cos))


def _wide_step_parity(hidden: int, heads: int):
    """One contrastive step at 2 layers of ``hidden`` (``heads`` heads,
    FFN 4 x hidden) made in bf16 for the card and in f32 for the CPU,
    on a padded batch: (the card step, its params, the batch, grads ->
    each leaf group's cosine against the CPU step's gradients)."""
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.training import make_train_step

    cfg = ModelConfig(name="t", hidden_size=hidden, num_layers=2, num_heads=heads,
                      intermediate_size=4 * hidden, vocab_size=30522, max_position=128)
    g = torch.Generator().manual_seed(1)
    ids = {k: torch.randint(5, 30000, (4, 64), generator=g) for k in ("q_ids", "d_ids")}
    masks = {k: (torch.arange(64)[None, :] < torch.tensor([64, 50, 20, 8])[:, None]).int()
             for k in ("q_mask", "d_mask")}
    batch = {**ids, **masks}
    params = random_params(cfg, seed=1)
    card, card_init = make_train_step(cfg, device="cuda")
    cpu, cpu_init = make_train_step(cfg, device="cpu")
    card_params, _ = card_init(params)
    _, want = cpu.value_and_grad(cpu_init(params)[0], batch)
    groups = {"q": ("q_w", "q_b"), "k": ("k_w",), "v": ("v_w", "v_b"), "o": ("o_w", "o_b"),
              "ffn": ("ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b")}

    def cosines(grads):
        out = {}
        for group, names in groups.items():
            a = torch.cat([grads["layers"][n].float().cpu().flatten() for n in names]).double()
            b_ = torch.cat([want["layers"][n].flatten() for n in names]).double()
            out[group] = float(torch.nn.functional.cosine_similarity(a, b_, dim=0))  # 0 if a == 0
        a = grads["embeddings"]["word"].float().cpu().double().flatten()
        b_ = want["embeddings"]["word"].double().flatten()
        out["embeddings"] = float(torch.nn.functional.cosine_similarity(a, b_, dim=0))
        return out

    counts = (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.LAUNCHES, ffn.WIDTH_LAUNCHES[hidden])
    _, grads = card.value_and_grad(card_params, batch)
    torch.cuda.synchronize()
    # K2, K10 and K3 (at this width) 4 times each
    assert (fa.LAUNCHES - counts[0], fa.BWD_LAUNCHES - counts[1], ffn.LAUNCHES - counts[2],
            ffn.WIDTH_LAUNCHES[hidden] - counts[3]) == (4, 4, 4, 4)
    return card, card_params, batch, cosines, grads


def test_bge_base_width_step_on_cuda_matches_the_cpu_and_sees_a_wrong_k10(gen):
    """One contrastive step's gradients at the bge-base width (2 layers,
    hidden 768, 12 heads of 64, FFN 3,072) in bf16 on the card (K2 and K10
    at 64, K3's 768 design; 4 launches each) against f32 on the CPU, padded
    batch: each leaf group's gradient cosine >= 0.999 (chip_smoke.py's bar).
    The control, K10 with its dQ zeroed, drops the q group's cosine to 0
    (a zero gradient: the cosine's eps makes it 0, not nan)."""
    card, card_params, batch, cosines, grads = _wide_step_parity(768, 12)
    real = cosines(grads)
    assert min(real.values()) >= 0.999, real
    k10 = fa.flash_attention_bwd

    def dq_zeroed(*a, **kw):
        dq, dk, dv = k10(*a, **kw)
        return torch.zeros_like(dq), dk, dv

    fa.flash_attention_bwd = dq_zeroed
    try:
        _, bad = card.value_and_grad(card_params, batch)
    finally:
        fa.flash_attention_bwd = k10
    assert cosines(bad)["q"] < 0.999


def test_bge_large_width_step_on_cuda_matches_the_cpu(gen):
    """One contrastive step at the bge-large width (2 layers, hidden 1,024,
    16 heads of 64, FFN 4,096) in bf16 on the card, K3's 1,024 design in
    every forward (4 launches, with K2 and K10), against f32 on the CPU on
    a padded batch: each leaf group's gradient cosine >= 0.999."""
    cosines, grads = _wide_step_parity(1024, 16)[3:]
    cos = cosines(grads)
    assert min(cos.values()) >= 0.999, cos


def test_tinybert_width_rerank_step_on_cuda_matches_the_cpu(gen):
    """One listwise rerank step at ms-marco-TinyBERT-L-4's width (4 layers
    of 312, 12 heads of 26, FFN 1,200: K2 and K10 padded to 32, K3's
    generic route) in bf16 on the card against f32 on the CPU on 8 groups
    of 4 padded rows of up to 128 tokens: the loss within 1e-3, each leaf
    group's gradient cosine >= 0.999 (chip_smoke.py's bars), K2, K10 and K3
    once a layer."""
    import numpy as np

    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.training import rerank_ft

    cfg = ModelConfig(name="t", hidden_size=312, num_layers=4, num_heads=12,
                      intermediate_size=1200, vocab_size=30522, max_position=512, num_labels=1)
    rng = np.random.default_rng(3)
    lens = rng.integers(8, 129, size=(8, 4))
    mask = (np.arange(128)[None, None, :] < lens[:, :, None]).astype(np.int32)
    batch = {"ids": rng.integers(5, 30000, size=(8, 4, 128)).astype(np.int32), "mask": mask,
             "types": ((np.arange(128)[None, None, :] >= lens[:, :, None] // 2) * mask)
             .astype(np.int32)}
    params = random_params(cfg, seed=3)
    card, card_init = rerank_ft.make_rerank_train_step(cfg, device="cuda")
    cpu, cpu_init = rerank_ft.make_rerank_train_step(cfg, device="cpu")
    want_loss, want = cpu.value_and_grad(cpu_init(params)[0], batch)
    counts = (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.WIDTH_LAUNCHES[312])
    loss, grads = card.value_and_grad(card_init(params)[0], batch)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - counts[0], fa.BWD_LAUNCHES - counts[1],
            ffn.WIDTH_LAUNCHES[312] - counts[2]) == (4, 4, 4)
    assert abs(float(loss) - float(want_loss)) <= 1e-3
    groups = {"q": ("q_w", "q_b"), "k": ("k_w",), "v": ("v_w", "v_b"), "o": ("o_w", "o_b"),
              "ffn": ("ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b")}
    for group, names in groups.items():
        a = torch.cat([grads["layers"][n].float().cpu().flatten() for n in names]).double()
        b_ = torch.cat([want["layers"][n].flatten() for n in names]).double()
        assert float(torch.nn.functional.cosine_similarity(a, b_, dim=0)) >= 0.999, group


# ----------------------------------------------- tensor parallel (K11, gloo)


class _ModelAxis:
    def __init__(self, tp):
        self.shape = {"model": tp}


@pytest.mark.parametrize("tp", [2, 4])
def test_flash_attention_tp_kernel_matches_plain_at_local_heads(gen, tp):
    """K11 at one rank's local heads of the 12 (6 heads, width 192, 384-byte
    rows at tp2; 3 heads, width 96, 192-byte rows at tp4), S = 200 (tiles
    part-filled), a padded row and a fully masked one: the output and
    dq/dk/dv through autograd each within 2^-6 of every (position, head)
    row's largest value of the plain versions at the same head count;
    masked keys' dk/dv exactly zero; K2, K10 and K11's counters each count
    one launch. A slice of a wider tensor (not contiguous) is refused."""
    b, s, heads = 3, 200, 12 // tp
    q, k, v = (_randn(gen, b, s, heads * 32, dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    do = _randn(gen, b, s, heads * 32, dtype=torch.bfloat16)
    bias = torch.where(_mask(b, s) > 0, 0.0, -1e9).float()
    counts = lambda: (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.TP_LAUNCHES, fa.TP_BWD_LAUNCHES)
    before = counts()
    out = fa.flash_attention_tp(q, k, v, bias, num_heads=12, mesh=_ModelAxis(tp))
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    want_out = fa.flash_attention_plain(qd, kd, vd, bias, num_heads=heads)
    want = fa.flash_attention_bwd_plain(qd, kd, vd, bias, do, num_heads=heads)
    assert _row_rel_err(out.detach(), want_out, heads) <= 2.0 ** -6
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g.float()).all(), name
        assert _row_rel_err(g, w, heads) <= 2.0 ** -6, (name, _row_rel_err(g, w, heads))
    assert (got[1][1, s // 3:] == 0).all() and (got[2][1, s // 3:] == 0).all()
    wide = _randn(gen, b, s, 384, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_tp(wide[..., :heads * 32], kd, vd, bias, num_heads=12,
                              mesh=_ModelAxis(tp))


@pytest.mark.parametrize("rows", [2, 30522])
def test_replicated_embedding_backward_is_run_independent_on_the_card(gen, rows):
    """The TP path's embedding lookup on the card at one dp2 x tp2 rank's
    contrastive encode (32 x 128 ids; token types all 0, word ids with a
    quarter of the rows one id, the rest random): the table gradient has
    the same bits on 5 runs (CUDA's F.embedding backward does not above
    3,072 ids; PERF.md) and agrees with F.embedding's within f32 rounding."""
    from financial_rag_tpu_torch.models.bert import _ReplicatedEmbedding

    ids = torch.randint(0, rows, (32, 128), generator=gen, device="cuda")
    ids[:8] = 0
    table = _randn(gen, rows, 384).requires_grad_()
    g = _randn(gen, 32, 128, 384)
    runs = [torch.autograd.grad(_ReplicatedEmbedding.apply(ids, table), table, g)[0]
            for _ in range(5)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    (ref,) = torch.autograd.grad(torch.nn.functional.embedding(ids, table), table, g)
    torch.testing.assert_close(runs[0], ref, atol=1e-4, rtol=1e-5)


def test_row_parallel_partial_product_runs_a_bf16_gemm_to_f32_on_the_card(gen):
    """The row-parallel partial product at one tp2 rank's FFN-out shape
    (4,096 x 768 by 768 x 384, bf16): float32 out, within f32 summation
    order of the upcast product, and bf16 gradients within 2^-7 of each
    gradient's largest value of autograd's f32 ones."""
    from financial_rag_tpu_torch.models.bert import _PartialProduct

    x = _randn(gen, 32, 128, 768, dtype=torch.bfloat16).requires_grad_()
    w = _randn(gen, 768, 384, dtype=torch.bfloat16, scale=0.05).requires_grad_()
    g = _randn(gen, 32, 128, 384, dtype=torch.bfloat16).float()
    out = _PartialProduct.apply(x, w)
    assert out.dtype == torch.float32
    xf, wf = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
    want = xf @ wf
    assert (out - want).abs().max() <= 1e-5 * want.abs().max()
    for a, b in zip(torch.autograd.grad(out, (x, w), g), torch.autograd.grad(want, (xf, wf), g)):
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max() <= 2.0 ** -7 * b.abs().max()


def test_two_rank_tp_step_on_one_card_matches_the_single_gpu_step(gen):
    """One contrastive step on dp1 x tp2, two ranks sharing the card over
    gloo (K11 at 6 heads, the f32 row-parallel all-reduces), against the
    single-GPU step (K2/K10/K3) on the same bf16 weights and padded batch,
    2 layers at hidden 384: loss within 1e-2, and each leaf group's
    gradient cosine >= 0.999 and norm ratio within 1 +- 0.01 (the two
    paths round at other points: the TP FFN is not K3). K11 launched once
    per layer and encode, forward and backward, on rank 0."""
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.parallel import launch
    from financial_rag_tpu_torch.training import make_train_step

    fields = dict(name="t", hidden_size=384, num_layers=2, num_heads=12,
                  intermediate_size=1536, vocab_size=30522, max_position=128)
    cfg = ModelConfig(**fields)
    rng = np.random.default_rng(0)
    lens = np.array([40, 30, 12, 5])
    batch = {**{k: rng.integers(5, 30000, size=(4, 40)).astype(np.int32)
                for k in ("q_ids", "d_ids")},
             **{k: (np.arange(40)[None, :] < lens[:, None]).astype(np.int32)
                for k in ("q_mask", "d_mask")}}
    params = {g: {k: t.numpy() for k, t in leaves.items()}
              for g, leaves in random_params(cfg, seed=0).items()}
    ranks = launch.spawn(workers.step_grads, 2, args=(fields, params, batch, 2),
                         device="cuda", timeout_s=120, join_timeout_s=300)
    card, init_state = make_train_step(cfg, device="cuda")
    masters, _ = init_state(params)
    want_loss, want = card.value_and_grad(masters, batch)
    got = ranks[0]
    assert got["launches"] == (4, 4)
    assert abs(got["loss"] - float(want_loss)) <= 1e-2
    groups = {"qkv": ("q_w", "k_w", "v_w"), "o": ("o_w",), "ffn": ("ffn_in_w", "ffn_out_w"),
              "norms": ("attn_ln_scale", "ffn_ln_scale")}
    for group, names in groups.items():
        a = np.concatenate([got["grads"]["layers"][n].ravel() for n in names]).astype(np.float64)
        w = np.concatenate([want["layers"][n].float().cpu().numpy().ravel()
                            for n in names]).astype(np.float64)
        cos = a @ w / (np.linalg.norm(a) * np.linalg.norm(w))
        assert cos >= 0.999, (group, cos)
        assert abs(np.linalg.norm(a) / np.linalg.norm(w) - 1) <= 0.01, group
    a, w = got["grads"]["embeddings"]["word"].ravel(), want["embeddings"]["word"].float().cpu().numpy().ravel()
    assert a @ w / (np.linalg.norm(a) * np.linalg.norm(w)) >= 0.999


def test_kernel_ab_times_both_trees_and_compares_their_outputs(gen, tmp_path, monkeypatch):
    """scripts/kernel_ab.py against its own csrc/: every row (K1, K4, K5,
    K7, K6, K2, K3, K10, K9; the generic shapes of K2, K10 and K9 also as
    the kernel alone on pre-padded inputs, K10 also at its tuned widths at
    the generic shapes) has two loop times and two device times for
    each tree (a device time at most 1.5x the loop's), the rows of the
    sweeps K4-K7 also a sweep and a merge device time that sum to it (K7's
    with its sort's), and the two builds of the same sources agree exactly;
    --only keeps the kernels named."""
    import json

    from financial_rag_tpu_torch.ops import kernel_lib
    from financial_rag_tpu_torch.scripts import kernel_ab

    monkeypatch.setenv("FRAG_KERNEL_BUILD_DIR", str(tmp_path))
    out = tmp_path / "ab.json"
    assert kernel_ab.main(["--other", str(kernel_lib.CSRC), "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert len(rows) == (len(kernel_ab.K1_SHAPES) + len(kernel_ab.K4_SHAPES)
                         + len(kernel_ab.K5_SHAPES) + len(kernel_ab.K6_SHAPES)
                         + len(kernel_ab.K7_SHAPES)
                         + len(kernel_ab.K2_SHAPES) + 2 * len(kernel_ab.K2_GENERIC_SHAPES)
                         + len(kernel_ab.K3_SHAPES) + len(kernel_ab.K3_GENERIC_SHAPES)
                         + len(kernel_ab.K10_SHAPES) + 2 * len(kernel_ab.K10_GENERIC_SHAPES)
                         + len(kernel_ab.K10_TUNED_SHAPES) + len(kernel_ab.K10_PADDED_SHAPES)
                         + len(kernel_ab.K9_SHAPES) + len(kernel_ab.K9_GENERIC_LABELS))
    assert [r["kernel"] for r in rows].count("K2") == (len(kernel_ab.K2_SHAPES)
                                                       + 2 * len(kernel_ab.K2_GENERIC_SHAPES))
    assert [r["shape"][-1] for r in rows
            if r["kernel"] == "K2"].count("kernel alone") == len(kernel_ab.K2_GENERIC_SHAPES)
    k10 = [r for r in rows if r["kernel"] == "K10"]
    assert len(k10) == (len(kernel_ab.K10_SHAPES) + 2 * len(kernel_ab.K10_GENERIC_SHAPES)
                        + len(kernel_ab.K10_TUNED_SHAPES) + len(kernel_ab.K10_PADDED_SHAPES))
    assert [r["shape"][3] for r in k10].count(64) == 10 and not any("refused" in r for r in rows)
    for kernel, generic in (("K10", kernel_ab.K10_GENERIC_SHAPES),
                            ("K9", kernel_ab.K9_GENERIC_LABELS)):
        assert [r["shape"][-1] for r in rows
                if r["kernel"] == kernel].count("kernel alone") == len(generic)
    assert [r["shape"][-1] for r in k10].count("padded") == len(kernel_ab.K10_PADDED_SHAPES)
    assert [r["kernel"] for r in rows].count("K1") == len(kernel_ab.K1_SHAPES)
    for row in rows:
        if row["kernel"] == "K3":   # both trees are this one: the same split
            assert row["shape"]["splits"]["this"] == row["shape"]["splits"]["other"]
        if row["kernel"] in ("K4", "K5", "K6", "K7"):   # the same groups; the parts make the whole
            assert row["shape"]["groups"]["this"] == row["shape"]["groups"]["other"]
            for tree in ("this", "other"):
                sort = row.get(f"{tree}_sort_dev_ms", [0.0, 0.0])
                assert (row["kernel"] == "K7") == (f"{tree}_sort_dev_ms" in row)
                for total, sweep, merge, rest in zip(row[f"{tree}_dev_ms"],
                                                     row[f"{tree}_sweep_dev_ms"],
                                                     row[f"{tree}_merge_dev_ms"], sort):
                    assert sweep > 0 and merge > 0
                    assert abs(sweep + merge + rest - total) <= 1e-9 + 1e-6 * total
    for row in rows:
        assert len(row["this_ms"]) == len(row["other_ms"]) == 2
        assert len(row["this_dev_ms"]) == len(row["other_dev_ms"]) == 2
        assert all(0 < t <= 1.5 * max(row["this_ms"] + row["other_ms"])
                   for t in row["this_dev_ms"] + row["other_dev_ms"]), row
        assert row["max_rel_diff"] == 0.0, row
    only = tmp_path / "only.json"
    assert kernel_ab.main(["--other", str(kernel_lib.CSRC), "--out", str(only),
                           "--only", "K5,K7"]) == 0
    assert [r["kernel"] for r in json.loads(only.read_text())["rows"]] == (
        ["K5"] * len(kernel_ab.K5_SHAPES) + ["K7"] * len(kernel_ab.K7_SHAPES))


# ------------------------------------------- multi-device serving (cuda:0)


def _grid_shards(gen, idx, cpu, rows_per_shard):
    """Give both indexes the same 1/64-grid rows (small integers for int8,
    beside the upsert's row weights) in every shard's first rows (the slot
    maps come from a normal upsert), so every score is exact and the two
    paths must agree bit for bit."""
    n = rows_per_shard * idx.n_shards
    ids = list(range(1, n + 1))
    x = _randn(gen, n, idx.dim).cpu().numpy()
    for index in (idx, cpu):
        index.upsert(ids, x)
    for s in range(idx.n_shards):
        if idx.dtype == torch.int8:    # small integers: exact integer dots
            g = torch.randint(-3, 4, (rows_per_shard, idx.dim), generator=gen,
                              device="cuda").to(torch.int8)
        else:
            g = _grid(gen, rows_per_shard, idx.dim).to(idx.dtype)
        idx.shards[s]._vectors[:rows_per_shard] = g
        cpu.shards[s]._vectors[:rows_per_shard] = g.cpu()
    return ids


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_flat_index_runs_k7_per_shard_exactly(gen, dtype):
    """Four shards on cuda:0 (the shards wrap onto the one card): one K7
    launch a shard and a search, and the merged result bit-equal to the
    CPU's composition of K7's plain version, shard by shard."""
    from financial_rag_tpu_torch.parallel import ShardedFlatIndex, search_devices

    devices = search_devices(4, "cuda")
    assert len(devices) == 4
    idx = ShardedFlatIndex(devices, dim=384, capacity_per_shard=8192, dtype=DTYPES[dtype])
    cpu = ShardedFlatIndex(search_devices(4, "cpu"), dim=384, capacity_per_shard=8192,
                           dtype=DTYPES[dtype], backend="pallas_bucketed")
    assert idx.backend == "pallas_bucketed"
    ids = _grid_shards(gen, idx, cpu, 6000)
    for index in (idx, cpu):
        index.delete(ids[::7])
    q = _grid(gen, 8, 384).cpu().numpy()
    before = topk.LAUNCHES["bucketed_topk"]
    got = idx.search(q, 24)
    assert topk.LAUNCHES["bucketed_topk"] == before + 4
    want = cpu.search(q, 24)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()


def _sign_rows(gen, n, d, nnz=16):
    """Unit rows of ``nnz`` entries +-1/4, the rest 0: exact in bf16, and
    every dot product of two is a multiple of 1/16, exact in f32 in any
    order."""
    pos = torch.rand(n, d, generator=gen, device="cuda").argsort(dim=1)[:, :nnz]
    sign = torch.randint(0, 2, (n, nnz), generator=gen, device="cuda").float() * 2 - 1
    rows = torch.zeros(n, d, device="cuda").scatter_(1, pos, sign / nnz ** 0.5)
    return rows.cpu().numpy()


def test_sharded_ivf_index_runs_k8_per_shard(gen):
    """Four IVF shards on cuda:0: one K8 launch a shard and a search, and
    ids and scores equal to the CPU shards' (K8's plain version). Rows,
    queries and centroids make every score exact, so both sides fill the
    same lists, probe the same lists and break the same ties."""
    from financial_rag_tpu_torch.parallel import ShardedIVFIndex, search_devices

    x = _sign_rows(gen, 4000, 384)
    centroids = torch.from_numpy(_sign_rows(gen, 16, 384))
    idx = ShardedIVFIndex(search_devices(4, "cuda"), dim=384, nlist=16, list_size=256,
                          nprobe=4)
    cpu = ShardedIVFIndex(search_devices(4, "cpu"), dim=384, nlist=16, list_size=256,
                          nprobe=4)
    assert [s.device.type for s in idx.shards] == ["cuda"] * 4
    for index in (idx, cpu):
        for shard in index.shards:
            shard.centroids = centroids.to(shard.device)
        index.upsert(list(range(1, 4001)), x)
        index.delete(list(range(5, 4001, 9)))
    q = np.concatenate([x[:3], _sign_rows(gen, 5, 384)])
    before = ivf_probe.LAUNCHES
    got = idx.search(q, 10)
    assert ivf_probe.LAUNCHES == before + 4
    want = cpu.search(q, 10)
    assert (got[0][:3, 0] == [1, 2, 3]).all() and (got[1][:3, 0] == 1.0).all()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_data_parallel_encoder_matches_one_device(gen):
    """Two replicas on cuda:0: each batch's halves run K1-K3 apart, then
    gather; the embeddings match the one-device encoder's by cosine (K3's
    split changes with the token count, so not bit for bit)."""
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.models.encoder import Encoder

    cfg = ModelConfig(name="bge-small-2l", hidden_size=384, num_layers=2, num_heads=12,
                      intermediate_size=1536, vocab_size=30522, max_position=512)
    params = random_params(cfg, seed=0)
    texts = [f"the rent for year {i} is {1000 * i} rupees per month" for i in range(40)]
    one = Encoder(cfg, params, batch_size=32, device="cuda")
    dp = Encoder(cfg, params, batch_size=32, device="cuda",
                 replicas=[torch.device("cuda", 0)] * 2)
    assert len(dp._params_on) == 1
    before = pn.LAUNCHES
    got = dp.encode(texts)
    assert pn.LAUNCHES == before + 4          # 2 batches (32 + 8 rows) x 2 replicas
    want = one.encode(texts)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.9999, cos.min()


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_ingest_flush_syncs_the_card_of_every_shard_once(gen, kind, monkeypatch):
    """Four shards on cuda:0 (they wrap onto the one card): flush calls
    torch.cuda.synchronize once, for cuda:0, and leaves no work queued."""
    from types import SimpleNamespace

    from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline
    from financial_rag_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, search_devices

    devices = search_devices(4, "cuda")
    idx = (ShardedFlatIndex(devices, dim=384, capacity_per_shard=8192) if kind == "flat" else
           ShardedIVFIndex(devices, dim=384, nlist=16, list_size=256, nprobe=4))
    x = _sign_rows(gen, 4000, 384)
    if kind == "ivf":
        idx.train(x[:1024], iters=2)
    idx.upsert(list(range(1, 4001)), x)
    real, calls = torch.cuda.synchronize, []

    def counting(device=None):
        calls.append(device)
        real(device)
    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    IngestionPipeline.flush(SimpleNamespace(indexes={"baai": idx}))
    assert calls == [torch.device("cuda", 0)]
    assert torch.cuda.current_stream().query()


# ------------------------------------------ the multivector tier, decoder TP


def _token_sets(gen, n, t, d):
    """n children of 1..t unit token rows on the card (numpy for upsert)."""
    lens = torch.randint(1, t + 1, (n,), generator=gen, device="cuda").tolist()
    return [torch.nn.functional.normalize(_randn(gen, ln, d), dim=1).cpu().numpy()
            for ln in lens]


def test_multivector_index_on_cuda_matches_the_cpu(gen):
    """MaxSim of 1,000 children (1-32 tokens of 384, bf16 storage, grown
    once from 512 slots) on the card against the same upserts on the CPU
    in bf16 storage (exact bf16 products in f32 on both): identical ids
    outside ties of 1e-4, scores within 1e-4; a deleted child never
    surfaces; a child's own tokens find it first."""
    from financial_rag_tpu_torch.index import MultiVectorIndex

    toks = _token_sets(gen, 1000, 32, 384)
    card = MultiVectorIndex(dim=384, max_child_tokens=32, capacity=512, device="cuda")
    cpu = MultiVectorIndex(dim=384, max_child_tokens=32, capacity=512, device="cpu")
    for idx in (card, cpu):
        idx.upsert(np.arange(1, 1001), toks)
        idx.delete([3])
    assert card.capacity == 1024 and card._tokens.is_cuda and card.count() == 999
    for i in (1, 500, 998):             # children 2, 501, 999 (3 is deleted)
        q = toks[i][:16]
        got, want = card.search_aggregate(q, top_k=24), cpu.search_aggregate(q, top_k=24)
        assert 3 not in [h["child_id"] for h in got]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                   rtol=0, atol=1e-4)
        for g, w in zip(got, want):
            assert g["child_id"] == w["child_id"] or abs(g["score"] - w["score"]) <= 1e-4
        assert got[0]["child_id"] == i + 1


def test_token_encoder_launches_k2_k3_and_matches_the_cpu(gen):
    """TokenEncoder on a 2-layer bge-small-width encoder on the card (bf16)
    launches K2 and K3 once a layer per forward and matches the same
    weights on the CPU (f32, plain versions) at cosine >= 0.999 per token,
    with the same ragged shapes."""
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.models.encoder import Encoder, TokenEncoder

    cfg = ModelConfig(name="bge-small-2l", hidden_size=384, num_layers=2, num_heads=12,
                      intermediate_size=1536, vocab_size=30522, max_position=512)
    params = random_params(cfg, seed=0)
    texts = ["the lock-in period is 36 months", "gst " * 90, "a", "",
             "the annual premium is Rs 82,500 payable before 15 June each year"]
    card = TokenEncoder(Encoder(cfg, params, device="cuda"), max_tokens=128)
    before = (fa.LAUNCHES, ffn.LAUNCHES)
    got = card.encode_tokens(texts)
    torch.cuda.synchronize()
    # two buckets (64 and 128 tokens): two forwards of 2 layers
    assert (fa.LAUNCHES - before[0], ffn.LAUNCHES - before[1]) == (4, 4)
    want = TokenEncoder(Encoder(cfg, params, device="cpu"), max_tokens=128).encode_tokens(texts)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        cos = (g * w).sum(1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1))
        assert cos.min() >= 0.999, cos.min()


def test_ingest_flush_syncs_the_multivector_tiers_card(gen, monkeypatch):
    """A flat index and a multivector tier on cuda:0: flush synchronises
    cuda:0 once and leaves the tier's upsert landed."""
    from types import SimpleNamespace

    from financial_rag_tpu_torch.index import MultiVectorIndex
    from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline

    flat = FlatIndex(dim=384, capacity=1024, device="cuda")
    flat.upsert(list(range(1, 65)), _sign_rows(gen, 64, 384))
    mv = MultiVectorIndex(dim=384, max_child_tokens=128, capacity=4096, device="cuda")
    mv.upsert(list(range(1, 1025)), _token_sets(gen, 1024, 128, 384))
    real, calls = torch.cuda.synchronize, []

    def counting(device=None):
        calls.append(device)
        real(device)
    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    IngestionPipeline.flush(SimpleNamespace(indexes={"baai": flat}, multivector_index=mv))
    assert calls == [torch.device("cuda", 0)]
    assert torch.cuda.current_stream().query()


def test_two_rank_tp_generate_on_one_card_matches_the_single_device_port(gen):
    """generate_tokens on dp1 x tp2, two ranks sharing the card over gloo
    (K9 on 2 query / 1 kv heads of 64 a rank, f32), against the
    single-device port on the same weights and left-padded prompts: the
    same greedy tokens on both ranks, and the same generate_tokens_spec
    tokens for the first row."""
    fields = dict(vocab_size=512, num_layers=2, hidden_size=256, num_heads=4, num_kv_heads=2,
                  intermediate_size=512, attention_bias=True, eos_token_id=0)
    cfg = decoder.DecoderConfig(**fields)
    full = decoder.random_decoder_params(cfg, seed=3, device="cpu")
    tree = {k: v.numpy() for k, v in full.items() if k != "layers"}
    tree["layers"] = {k: np.stack([lp[k].numpy() for lp in full["layers"]])
                      for k in full["layers"][0]}
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 512, (2, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :13] = 0
    from financial_rag_tpu_torch.parallel import launch

    ranks = launch.spawn(workers.decoder_tp_generate, 2, args=([(fields, tree, ids, mask, True)],
                                                               2, 8),
                         device="cuda", timeout_s=120, join_timeout_s=300)
    params = decoder.decoder_params_from_numpy(tree, device="cuda")
    want = decoder.generate_tokens(params, ids, mask, cfg=cfg, max_new_tokens=8).cpu().numpy()
    spec, steps = decoder.generate_tokens_spec(params, ids[:1], mask[:1], cfg=cfg,
                                               max_new_tokens=8, draft_k=4)
    for r in ranks:
        np.testing.assert_array_equal(r["cases"][0]["tokens"], want)
        np.testing.assert_array_equal(r["cases"][0]["spec_tokens"], spec.numpy())
        assert r["cases"][0]["spec_steps"] == steps
