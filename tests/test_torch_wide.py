"""The bge-base width (hidden 768, 12 heads of 64, FFN 3,072, index D 768)
in the port against the JAX package.

Each plain PyTorch version the widened kernels are held against on the card
(K2 at head_dim 64, K3 at hidden 768, K4, K5 and K7 at D 768) runs on the
same numpy inputs as the JAX function, with Pallas in interpret mode; the
wrappers' launch plans at the new widths are checked as plain Python; and a
2-layer bge-base-shape runtime in the port answers the golden questions as
the JAX runtime does.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from financial_rag_tpu.config import FrameworkConfig as JaxFrameworkConfig
from financial_rag_tpu.config import ModelConfig as JaxModelConfig
from financial_rag_tpu.models import checkpoint as jckpt
from financial_rag_tpu.ops import flash_attention as jax_flash_attention
from financial_rag_tpu.ops import packed_topk_fused as jax_packed_topk_fused
from financial_rag_tpu.ops import topk as jax_topk
from financial_rag_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from financial_rag_tpu.runtime import Runtime as JaxRuntime
from financial_rag_tpu_torch.config import FrameworkConfig, ModelConfig
from financial_rag_tpu_torch.index import flat as flat_mod
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.ops import fused_ffn as ffn
from financial_rag_tpu_torch.ops import topk
from financial_rag_tpu_torch.runtime import Runtime
from financial_rag_tpu_torch.training import contrastive, rerank_ft

torch.set_num_threads(2)

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100_SMS = 132


def _both(x: np.ndarray, dtype: str = "float32"):
    return (jnp.asarray(x, JAX_DT[dtype]),
            torch.from_numpy(np.ascontiguousarray(x)).to(TORCH_DT[dtype]))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _grid(rng, shape):
    """Coordinates on a 1/16 grid: every dot product of 768 features is an
    exact multiple of 2^-8 below 2^24 of them, so exact in f32 (and in
    bf16 storage) whatever the summation order."""
    return (rng.integers(-3, 4, size=shape) / 16.0).astype(np.float32)


# --------------------------------------------------------------------- K2


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_flash_attention_plain_matches_pallas_at_head_dim_64(dtype, atol):
    """Two heads of 64 (h = 128), S = 128: a padded row and a fully masked
    one, against the Pallas kernel in interpret mode; the bars of the
    head_dim 32 test."""
    rng = np.random.default_rng(21)
    b, s, h, heads = 3, 128, 128, 2
    q, k, v = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, 70:] = 0
    mask[2, :] = 0
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    ref = jax_flash_attention(jq, jk, jv, jnp.asarray(bias.reshape(b, 1, 1, s)),
                              num_heads=heads, interpret=True)
    out = fa.flash_attention_plain(tq, tk, tv, torch.from_numpy(bias), num_heads=heads)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (b, s, h)
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol)


# --------------------------------------------------------------------- K3


def _gelu_gap() -> float:
    v = np.linspace(-12, 12, 480001)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=False), np.float64)
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=True), np.float64)
    return float(np.abs(exact - tanh).max())


def test_fused_ffn_plain_vs_pallas_at_hidden_768_within_gelu_gap():
    """300 tokens (not a multiple of any tile) at H = 768, I = 3,072: the TPU
    kernel's tanh GELU against the port's erf GELU, each output within
    gap * ||W2[:, j]||_1 (+ f32 summation noise)."""
    rng = np.random.default_rng(22)
    n, h, i = 300, 768, 3072
    x = rng.standard_normal((n, h)).astype(np.float32)
    w1 = (rng.standard_normal((h, i)) / np.sqrt(h)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(i)).astype(np.float32)
    w2 = (rng.standard_normal((i, h)) / np.sqrt(i)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    ref = np.asarray(jax_fused_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                                   interpret=True))
    out = ffn.fused_ffn_plain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2))).numpy()
    bound = _gelu_gap() * np.abs(w2).sum(axis=0) + 1e-4
    assert out.shape == (n, h)
    assert np.all(np.abs(out - ref) <= bound[None, :])
    assert np.abs(out - ref).max() > 1e-6


# ------------------------------------------------------------- K4, K5, K7


def _wide_corpus(case):
    """7 queries over 4,096 rows of D = 768 on the exact grid, with dead
    slots or repeated rows (ties within a tile, across tiles and across
    bucket rounds)."""
    rng = np.random.default_rng(23)
    n, d = 4096, 768
    q, x = _grid(rng, (7, d)), _grid(rng, (n, d))
    valid = np.ones(n, np.float32)
    if case == "dead_slots":
        valid[rng.choice(n, 1500, replace=False)] = 0.0
    if case == "ties":
        x[1024:2048] = x[:1024]
        x[2048 + 5] = x[5]
        x[70] = x[5]
    return q, x, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "dead_slots", "ties"])
def test_packed_topk_plain_matches_pallas_at_d768(case, dtype):
    q, x, valid = _wide_corpus(case)
    jq, tq = _both(q)
    jx, tx = _both(x, dtype)
    ref_s, ref_i = jax_packed_topk_fused(jq, jx, jnp.asarray(valid), 24, interpret=True)
    out_s, out_i = topk.packed_topk_fused_plain(tq, tx, torch.from_numpy(valid), 24)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("name", ["bucketed_topk_fused", "bucketed_topk"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", ["plain", "dead_slots", "ties"])
def test_bucketed_sweeps_plain_match_pallas_at_d768(name, case, dtype):
    """K5 (the int8 index's sweep) and K7 at D = 768, 2,048 buckets (two
    rounds): int8 rows are integers with a per-row weight, so the integer
    dots and their weighting are exact, as they are in bf16 on the grid;
    ids and scores agree bit for bit, dead slots and ties included."""
    q, x, valid = _wide_corpus(case)
    if dtype == "int8":
        x8 = np.clip(np.round(x * 16), -127, 127)
        jx, tx = jnp.asarray(x8, jnp.int8), torch.from_numpy(x8).to(torch.int8)
        valid = valid * np.float32(0.01)
    else:
        jx, tx = _both(x, dtype)
    jax_fn = getattr(jax_topk, name)
    plain = getattr(topk, f"{name}_plain")
    ref_s, ref_i = jax_fn(jnp.asarray(q), jx, jnp.asarray(valid), 24, interpret=True,
                          nbuckets=2048)
    out_s, out_i = plain(torch.from_numpy(q), tx, torch.from_numpy(valid), 24, nbuckets=2048)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))


# ------------------------------------------------------------ launch plans


@pytest.mark.parametrize("s,consumers", [(64, 1), (128, 2), (512, 2)])
@pytest.mark.parametrize("head_dim", [32, 64])
def test_k2_block_fits_shared_memory(head_dim, s, consumers):
    """K2's block at both head widths: one warpgroup at S <= 64, else two;
    its shared memory in 227 KB, with room for as many blocks an SM as its
    registers allow. attn_fwd_kernel (head_dim 32, and 64 at S <= 64): Q
    tiles and a 4-stage ring of 64-key K/V tiles, two blocks an SM at S >
    64, three at head_dim 64 and S <= 64, four at head_dim 32.
    attn_fwd_d64_kernel (head_dim 64 above S = 64): two buffers of 128 Q
    rows, 3 stages of 64-key K and V tiles by TMA and the O staging tiles,
    99,328 bytes, two persistent blocks an SM."""
    got, smem = fa.fwd_block(s, head_dim)
    assert got == consumers
    assert smem <= topk.SMEM_BLOCK_LIMIT
    wide = head_dim == 64 and s > 64
    assert fa.fwd_kernel(s, head_dim) == ("attn_fwd_d64_kernel" if wide else "attn_fwd_kernel")
    blocks = 2 if consumers == 2 else (4 if head_dim == 32 else 3)
    if wide:
        assert smem == (2 * 128 + 3 * 2 * fa.FWD_WIDE_KEYS + 128) * 128 + 1024 == 99328
    assert blocks * (smem + 2048) <= 233472      # the SM's 228 KB, 1 KB reserved a block
    assert head_dim in fa.FWD_HEAD_DIMS


@pytest.mark.parametrize("head_dim,s,smem,blocks", [(32, 128, 35328, 6), (64, 128, 214016, 1),
                                                    (64, 512, 68096, 3)])
def test_k10_block_fits_shared_memory(head_dim, s, smem, blocks):
    """K10's block at both head widths. The two kernels (head_dim 32, and 64
    above S = 128): two resident 64-row tiles, a ring of 3 stages of two
    tiles and a query tile's statistics, 1 KB of alignment; six blocks an
    SM at head_dim 32, three at 64. The fused kernel (head_dim 64, S <=
    128): two buffers of Q, K, V and dO, the P and dS tiles and dq's
    staging tiles, 214,016 bytes, one block an SM. Above 48 KB the launch
    opts in."""
    path, kernels, got = fa.bwd_launch_plan(s, head_dim)
    assert got == smem
    if path == "two kernels":
        assert got == fa.bwd_smem_bytes(head_dim)
    assert smem <= topk.SMEM_BLOCK_LIMIT
    assert blocks * (smem + 1024) <= 233472 < (blocks + 1) * (smem + 1024)
    assert head_dim in fa.BWD_HEAD_DIMS


@pytest.mark.parametrize("head_dim,s,path", [(64, 1, "fused"), (64, 64, "fused"), (64, 100, "fused"),
                                             (64, 128, "fused"), (64, 129, "two kernels"),
                                             (64, 512, "two kernels"), (32, 64, "two kernels"),
                                             (32, 128, "two kernels"), (32, 512, "two kernels")])
def test_k10_launch_plan_picks_its_path_from_s(head_dim, s, path):
    """K10's path from S and the head width alone: the fused kernel at head
    width 64 up to S = 128 (every K10 launch of the train paths: S = 128,
    100, 64, and K11's local shapes), two kernels above and at head width
    32. The fused block's bytes: two buffers of four inputs of two 64-row
    tiles, the P and dS tiles of 2 x 2, dq's two staging tiles, 1 KB of
    alignment; the wrapper allocates the scratch only for the two kernels."""
    got, kernels, smem = fa.bwd_launch_plan(s, head_dim)
    assert got == path
    tile = 64 * 2 * head_dim
    if path == "fused":
        assert kernels == ("attn_bwd_fused_d64_kernel",)
        assert smem == 2 * (4 * 2 * tile) + (2 * 2 + 2 * 2 + 2) * tile + 1024
    else:
        assert kernels == ("attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")
        assert smem == 2 * tile + 3 * (2 * tile + 2 * 64 * 4) + 1024
    assert (s <= fa.FUSED_BWD_MAX_S and head_dim == 64) == (path == "fused")


def _ffn_cuda_constants():
    """csrc/fused_ffn.cu's ``constexpr int`` constants, evaluated in order."""
    src = (Path(ffn.__file__).parents[1] / "csrc" / "fused_ffn.cu").read_text()
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def test_k3_mirrors_equal_the_cuda_constants():
    """ops/fused_ffn.py's tiling of both designs is csrc/fused_ffn.cu's."""
    c = _ffn_cuda_constants()
    assert (c["kH"], c["kTokens"], c["kChunk"], c["kStages"]) == (
        ffn.KERNEL_HIDDEN, ffn.KERNEL_TOKENS, ffn.KERNEL_CHUNK, ffn.KERNEL_STAGES)
    assert (c["kWH"], c["kWRows"], c["kWChunk"], c["kWStages"], c["kWSlabBytes"]) == (
        ffn.WIDE_HIDDEN, ffn.WIDE_TOKENS, ffn.WIDE_CHUNK, ffn.WIDE_STAGES, ffn.WIDE_SLAB_BYTES)
    assert c["kSmemBytes"] == ffn.block_smem_bytes(384)
    assert c["kWSmemBytes"] == ffn.block_smem_bytes(768)


def test_k3_wide_shared_memory_sum():
    """The 768 design's block: the x rows (96 KB), two h tiles (8 KB each),
    4 ring stages of a 24 KB slab, the 1 KB alignment slack and the
    stages' full and empty barriers (static) within the 227 KB a block
    may take; a slab is 192 rows of W1's chunk (64 columns, 128 bytes) or
    16 rows of W2's (768 columns), whole k16 steps, and a chunk's W1 and
    W2 slabs pair up."""
    c = _ffn_cuda_constants()
    x, h_tile = 64 * 768 * 2, 64 * 64 * 2
    assert (c["kWXBytes"], c["kWHBytes"], c["kWSlabBytes"]) == (x, h_tile, 24576)
    assert c["kWW1Rows"] * c["kWChunk"] * 2 == c["kWW2Rows"] * 768 * 2 == c["kWSlabBytes"]
    assert c["kWW1Rows"] % 16 == 0 and c["kWW2Rows"] % 16 == 0 and c["kWChunk"] * 2 == 128
    assert c["kWW1Slabs"] == 768 // c["kWW1Rows"] == c["kWW2Slabs"] == c["kWChunk"] // c["kWW2Rows"]
    barriers = 2 * c["kWStages"] * 8
    assert x + 2 * h_tile + 4 * 24576 + 1024 == ffn.block_smem_bytes(768) == 214016
    assert ffn.block_smem_bytes(768) + barriers <= topk.SMEM_BLOCK_LIMIT


@pytest.mark.parametrize("h_dim,i_dim", [(384, 1536), (768, 3072), (768, 2048)])
def test_k3_block_fits_shared_memory_and_registers(h_dim, i_dim):
    """K3's two designs: x rows and the W1/W2 ring (at 768 also two h
    tiles) in 227 KB; each warpgroup's f32 slice of y in 192 registers a
    thread (the 384-wide design over 64 rows, the 768-wide one over its
    half of the columns) and its slice of a chunk's h in 16, under the 255
    a thread of a 256-thread block."""
    assert ffn.kernel_takes(h_dim, i_dim)
    assert ffn.block_smem_bytes(h_dim) <= topk.SMEM_BLOCK_LIMIT
    assert ffn.accumulator_registers(h_dim) == 192
    assert ffn.h_registers(h_dim) == 16
    assert ffn.accumulator_registers(h_dim) + ffn.h_registers(h_dim) <= 255 - 32


@pytest.mark.parametrize("n,h_dim,plan", [
    (512, 384, (128, 32, 12)), (131072, 384, (128, 32, 1)),
    (512, 768, (64, 64, 16)), (131072, 768, (64, 64, 1)), (999, 768, (64, 64, 8)),
    (64, 768, (64, 64, 24)), (17030, 768, (64, 64, 1)), (1, 768, (64, 64, 24)),
    (34816, 768, (64, 64, 1))])
def test_k3_launch_plan(n, h_dim, plan):
    """(tokens a block, I chunk, splits) on 132 SMs: a query's tokens split
    the I axis (at 768 so that the grid fits the card in one wave), with
    each split walking at least 128 I columns; an ingest batch is not
    split."""
    i_dim = 1536 if h_dim == 384 else 3072
    assert ffn.launch_plan(n, h_dim, i_dim, H100_SMS) == plan
    tokens, chunk, splits = plan
    assert (i_dim // splits) % chunk == 0 and i_dim // splits >= 128


@pytest.mark.parametrize("n,tiles", [
    (1, 1), (64, 1), (65, 2), (128, 2), (129, 3), (192, 3), (193, 4), (320, 5), (512, 8),
    (999, 16), (34816, 544), (131072, 2048)])
def test_k3_wide_grid_is_one_block_a_tile_and_split(n, tiles):
    """At 768 a block takes 64 tokens, the last tile ragged (1, 65, 129,
    193 and 999 tokens); the grid is the tiles times the splits, the splits
    in one wave below 132 tiles."""
    _, _, splits = ffn.launch_plan(n, 768, 3072, H100_SMS)
    assert -(-n // ffn.WIDE_TOKENS) == tiles
    assert tiles * ffn.WIDE_TOKENS - n < ffn.WIDE_TOKENS
    assert tiles * splits <= H100_SMS or splits == 1


@pytest.mark.parametrize("n", [1, 64, 512, 999, 34816, 131072])
@pytest.mark.parametrize("i_dim", [3072, 2048])
def test_k3_wide_grid_fits_one_wave_or_is_one_block_a_tile(n, i_dim):
    """At 768 a split grid fits the 132 SMs in one wave with the most splits
    that do (each split walking at least 2 chunks); from 132 blocks of
    tiles on, one block a tile and no split."""
    _, _, splits = ffn.launch_plan(n, 768, i_dim, H100_SMS)
    blocks = -(-n // ffn.WIDE_TOKENS)
    chunks = i_dim // ffn.WIDE_CHUNK
    assert chunks % splits == 0 and chunks // splits >= ffn.WIDE_MIN_CHUNKS
    if blocks >= H100_SMS:
        assert splits == 1
    else:
        assert blocks * splits <= H100_SMS
        more = [d for d in range(splits + 1, chunks // ffn.WIDE_MIN_CHUNKS + 1) if chunks % d == 0]
        assert all(blocks * d > H100_SMS for d in more)


@pytest.mark.parametrize("bq,d,qtile,stages", [
    (8, 384, 64, 6), (128, 384, 128, 5), (8, 768, 64, 2), (128, 768, 64, 2),
    (192, 768, 64, 2), (384, 768, 64, 2), (8, 1024, 64, 3), (128, 1024, 64, 3),
    (192, 1024, 64, 3)])
def test_k4_sweep_plan_fits_shared_memory(bq, d, qtile, stages):
    """K4's query tile and ring: at D = 768 one warpgroup of 64 queries and
    2 stages of 48 KB (two warpgroups' 192 KB of queries would leave no
    stage), so Bq = 128, 192 and 384 take 2, 3 and 6 query tiles over the
    corpus; at D = 1,024 one warpgroup (128 KB) and 3 stages of 16 rows (32
    KB); every block in 227 KB."""
    bqp, _, _, _, groups = topk.packed_sweep_grid(bq, 102400, H100_SMS, d=d)
    assert topk.query_tile(bqp, 2 * topk.padded_width(d)) == qtile
    got, smem = topk.packed_sweep_smem(d, qtile)
    assert got == stages and smem <= topk.SMEM_BLOCK_LIMIT
    base = (1024 // topk.packed_columns(d)) * -(-bqp // qtile)
    assert base * groups <= H100_SMS or groups == 1


@pytest.mark.parametrize("d,elem,bq,qtile,stages", [
    (384, 1, 128, 128, 12), (384, 2, 128, 128, 5), (384, 2, 8, 64, 7),
    (768, 1, 128, 128, 5), (768, 1, 1, 64, 7), (768, 2, 128, 64, 2), (768, 2, 1, 64, 2),
    (1024, 1, 128, 64, 5), (1024, 1, 1, 64, 5), (1024, 2, 128, 64, 3), (1024, 2, 1, 64, 3)])
def test_k5_sweep_plan_fits_shared_memory(d, elem, bq, qtile, stages):
    """K5's and K7's query tile and ring: an int8 row of 768 is 768 bytes,
    a bf16 row of 384 is too, so the int8 sweep at 768 keeps two query
    warpgroups and a 5-stage ring; a bf16 row of 768 leaves room for one
    warpgroup and 2 stages; at 1,024 one warpgroup, 5 stages of 32 rows in
    int8 and 3 of 16 rows in bf16. The plan the wrapper passes agrees."""
    row_bytes = topk.padded_width(d) * elem
    bqp, _, _ = topk.bucketed_sweep_grid(bq, 102400, 4096, H100_SMS, row_bytes)
    assert topk.query_tile(bqp, row_bytes) == qtile
    got, smem = topk.bucketed_sweep_smem(row_bytes, qtile)
    assert got == stages and got >= 2 and smem <= topk.SMEM_BLOCK_LIMIT


def test_int8_sweep_sums_stay_exact_at_d768():
    """127 x 127 x 768 = 12,386,304 < 2^24: the int8 dot at D = 768 is an
    integer an f32 holds exactly, as the plain version and the kernel's
    int32-to-f32 conversion both assume."""
    assert 127 * 127 * topk.SWEEP_MAX_D < 2 ** 24
    x = torch.full((4, 768), 127, dtype=torch.int8)
    assert topk._tile_scores(x, x)[0, 0].item() == 127 * 127 * 768


# -------------------------------------------- refusals of what stays narrow


def test_cuda_wrappers_refuse_the_widths_their_kernels_do_not_take():
    """On non-CPU tensors the wrappers check widths before the device: K2
    and K10 head_dim 128 and 80, K3 hidden 2,044 (rows not whole 16-byte
    chunks; 2,048 takes its generic route), K4 D 1,040; no launch is
    counted and nothing falls back to a plain version."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.LAUNCHES, topk.LAUNCHES["packed_topk_fused"])
    x = torch.empty(2, 65, 256, **meta)
    bias = torch.zeros(2, 65, device="meta")
    with pytest.raises(ValueError, match=r"\(K2\) takes head_dim <= 64"):
        fa.flash_attention(x, x, x, bias, num_heads=2)
    x = torch.empty(2, 65, 768, **meta)
    with pytest.raises(ValueError, match=r"\(K10\) takes head_dim <= 64 .*got H=768 over 6"):
        fa.flash_attention_bwd(x, x, x, torch.zeros(2, 65, device="meta"), x, num_heads=6)
    x = torch.empty(2, 65, 960, **meta)
    for fn in (fa.flash_attention, lambda *a, **kw: fa.flash_attention_bwd(*a, x, **kw)):
        with pytest.raises(ValueError, match=r"takes head_dim <= 64 .*got H=960 over 12"):
            fn(x, x, x, torch.zeros(2, 65, device="meta"), num_heads=12)
    x = torch.empty(8, 2044, **meta)
    w1, w2 = torch.empty(2044, 8176, **meta), torch.empty(8176, 2044, **meta)
    with pytest.raises(ValueError, match=r"\(K3\) takes H and I multiples of 8"):
        ffn.fused_ffn(x, w1, torch.empty(8176, **meta), w2, torch.empty(2044, **meta))
    q, c = torch.empty(2, 1040, **meta), torch.empty(1024, 1040, **meta)
    with pytest.raises(ValueError, match="at most 1024"):
        topk.packed_topk_fused(q, c, torch.ones(1024, device="meta"), 24)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.LAUNCHES,
            topk.LAUNCHES["packed_topk_fused"]) == before


def test_exact_backend_refuses_a_wide_index_on_cuda(monkeypatch):
    """K6 stays at D <= 384: a FlatIndex on CUDA with backend pallas_exact
    refuses a 768-wide int8 or bf16 index before it allocates, and takes an
    f32 one (K6's CUDA-core sweep) or any other backend; the CPU takes all."""
    monkeypatch.setattr(flat_mod, "resolve_device", lambda device=None: torch.device("cuda"))
    for dtype in (torch.bfloat16, torch.int8):
        with pytest.raises(NotImplementedError, match="takes D <= 384, the index has dim 768"):
            flat_mod.FlatIndex(dim=768, dtype=dtype, backend="pallas_exact")
    monkeypatch.undo()
    idx = flat_mod.FlatIndex(dim=768, capacity=1024, dtype=torch.bfloat16,
                             backend="pallas_exact", device="cpu")
    assert idx.backend == "pallas_exact"


@pytest.mark.parametrize("maker", [contrastive.make_train_step, rerank_ft.make_rerank_train_step])
@pytest.mark.parametrize("hidden,heads,refused", [(768, 6, True), (768, 12, False),
                                                  (768, 24, False), (384, 12, False)])
def test_training_on_cuda_refuses_head_dims_k10_does_not_take(monkeypatch, maker, hidden, heads,
                                                               refused):
    """make_train_step and make_rerank_train_step on a CUDA device refuse
    head_dim 128 up front, naming K10 (K2 would refuse the forward, and a
    wider K2 would leave K10 to raise in the middle of the first
    backward); head_dim 64 (bge-base) and 32 pass the check, and the CPU
    builds a step at every width."""
    cfg = ModelConfig(hidden_size=hidden, num_layers=1, num_heads=heads,
                      intermediate_size=4 * hidden, vocab_size=64, max_position=32)
    module = contrastive if maker is contrastive.make_train_step else rerank_ft
    monkeypatch.setattr(module, "resolve_device", lambda device=None: torch.device("cuda"))
    if refused:
        with pytest.raises(NotImplementedError, match=r"head_dim 128, but the attention "
                                                      r"backward \(K10\) takes head_dim "
                                                      r"<= 64 only"):
            maker(cfg)
    else:
        contrastive.check_train_widths(cfg, torch.device("cuda"))
    monkeypatch.undo()
    step, init_state = maker(cfg, device="cpu")
    assert callable(init_state)


# --------------------------------------------- the runtime at the wide shape

CORPUS = {
    "lease_2022": (
        "LEASE DEED executed between M/s Bhartiya Enterprises (the Lessor) and "
        "Acme Trading Pvt Ltd (the Lessee). The monthly rent for the second year "
        "shall be Rs 42,800. The lock-in period under this lease is 36 months. " * 2),
    "invoice_cn24": (
        "TAX INVOICE / CREDIT NOTE No. CN/24 issued by Bhartiya Enterprises. "
        "CGST at 9 percent: Rs 19,406.25. Total invoice amount Rs 2,54,434. " * 2),
    "insurance_policy": (
        "FIRE INSURANCE POLICY No. FI-9981 covering the warehouse at Chakulia. "
        "The sum insured is Rs 75,00,000. The annual premium is Rs 82,500. " * 2),
}
GOLDEN = [
    "What is the rent for the second year?",
    "What is the lock-in period of the lease?",
    "What is the total invoice amount on the credit note?",
    "What is the sum insured under the fire policy?",
]
WIDE = dict(hidden_size=768, num_layers=2, num_heads=12, intermediate_size=3072,
            vocab_size=30522, max_position=512)
CROSS = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             vocab_size=30522, max_position=512)


def _write_checkpoint(d, spec, seed, classifier=False):
    d.mkdir(parents=True)
    cfg = JaxModelConfig(**spec, num_labels=1 if classifier else 0)
    raw = {"hidden_size": spec["hidden_size"], "num_hidden_layers": spec["num_layers"],
           "num_attention_heads": spec["num_heads"],
           "intermediate_size": spec["intermediate_size"], "vocab_size": 30522,
           "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12}
    if classifier:
        raw.update(architectures=["BertForSequenceClassification"], id2label={"0": "LABEL_0"})
    (d / "config.json").write_text(json.dumps(raw))
    jckpt.save_params_npz(jckpt.random_params(cfg, seed=seed), d / "model.npz")


def _config(cls, ckpt):
    cfg = cls()
    cfg.encoders.baai_path = str(ckpt / "bge-base")
    cfg.encoders.gte_path = str(ckpt / "gte-base")
    cfg.rerank.model_path = str(ckpt / "ce")
    cfg.serving.microbatch = False
    cfg.llm.provider = "gemini"
    cfg.llm.gemini_api_key = None
    return cfg


@pytest.fixture(scope="module")
def wide_runtimes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wide")
    mp = pytest.MonkeyPatch()
    mp.delenv("FRAG_PLATFORM", raising=False)
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
    ckpt = tmp / "ckpt"
    _write_checkpoint(ckpt / "bge-base", WIDE, seed=31)
    _write_checkpoint(ckpt / "gte-base", WIDE, seed=32)
    _write_checkpoint(ckpt / "ce", CROSS, seed=33, classifier=True)
    src = tmp / "src"
    src.mkdir()
    for doc_id, text in CORPUS.items():
        (src / f"{doc_id}.json").write_text(json.dumps({"blocks": [{"content": text, "page": 0}]}))
    jrt = JaxRuntime.build(_config(JaxFrameworkConfig, ckpt), data_dir=tmp / "jax")
    trt = Runtime.build(_config(FrameworkConfig, ckpt), data_dir=tmp / "port", device="cpu")
    for rt in (jrt, trt):
        for doc_id in CORPUS:
            f = src / f"{doc_id}.json"
            out = rt.pipeline.ingest_extracted_json(f, doc_id, source_path=str(f),
                                                    source_mtime=0.0)
            assert "error" not in out and out["children"] > 0
    yield jrt, trt
    mp.undo()


def test_wide_runtime_embeddings_match_jax(wide_runtimes):
    """Both 768-wide encoders (baai CLS, gte mean pooling) on the same texts:
    the port's f32 CPU path within cosine 0.9999 of the JAX package's."""
    jrt, trt = wide_runtimes
    texts = [*GOLDEN, *(t[:300] for t in CORPUS.values())]
    jv, tv = jrt.dual_encoder.encode_all(texts), trt.dual_encoder.encode_all(texts)
    assert set(tv) == {"baai", "gte"}
    for name in ("baai", "gte"):
        a, b = np.asarray(jv[name], np.float64), np.asarray(tv[name], np.float64)
        assert b.shape == (len(texts), 768)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        assert cos.min() > 0.9999, (name, cos.min())


@pytest.mark.parametrize("question", GOLDEN)
def test_wide_runtime_same_children_as_jax(wide_runtimes, question):
    jrt, trt = wide_runtimes
    assert {i.dim for i in trt.indexes.values()} == {768}
    jout, tout = jrt.engine.query(question), trt.engine.query(question)
    assert jout["success"] and tout["success"]
    jtexts = [c["text"] for c in jout["top_children_chunks"]]
    ttexts = [c["text"] for c in tout["top_children_chunks"]]
    assert ttexts and ttexts == jtexts
    assert tout["answer"] == jout["answer"]


# ------------------------------- the feedback fine-tune at heads of 64

CE64 = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=512,
            vocab_size=30522, max_position=512)     # 2 heads of 64, the bge-base head width
FEEDBACK_ARGS = dict(steps=3, batch=4, group=3, seq=32, lr=1e-3)


def _seed_feedback(db):
    """Each golden question's result cached with three corpus sentences,
    rated 5 (even questions: positives) or 1 (odd: hard negatives)."""
    sentences = [t.strip() for text in CORPUS.values() for t in dict.fromkeys(text.split(". "))
                 if t.strip()]
    for i, question in enumerate(GOLDEN):
        chunks = [{"text": sentences[(3 * i + j) % len(sentences)]} for j in range(3)]
        db.cache_put(f"hash-{i}", question, {"top_children_chunks": chunks})
        db.store_feedback(query=question, rating=5 if i % 2 == 0 else 1)
    db.flush_writes()


def _jax_train_rerank_script():
    """The JAX package's scripts/train_rerank.py as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "scripts" / "train_rerank.py"
    spec = importlib.util.spec_from_file_location("jax_train_rerank_script", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tuned_rerankers(tmp_path_factory):
    """The port's ``train_rerank.py --feedback-db DB --model-path CKPT`` on
    the CPU and the JAX package's ``scripts/train_rerank.py`` feedback mode
    (its finetune_from_feedback on a 1 x 1 mesh, f32), from the same 2-layer
    head_dim-64 cross-encoder checkpoint and the same seeded feedback.
    Returns (tmp dir, the port's JSON line, the JAX script's)."""
    import contextlib
    import io
    from argparse import Namespace

    from financial_rag_tpu.store.feedback_db import FeedbackDatabase as JaxFeedbackDatabase
    from financial_rag_tpu_torch.scripts import train_rerank
    from financial_rag_tpu_torch.store.feedback_db import FeedbackDatabase
    from jax.sharding import Mesh

    tmp = tmp_path_factory.mktemp("tuned")
    _write_checkpoint(tmp / "ce64", CE64, seed=41, classifier=True)
    _seed_feedback(FeedbackDatabase(tmp / "port.db"))
    _seed_feedback(JaxFeedbackDatabase(tmp / "jax.db"))
    argv = ["--feedback-db", str(tmp / "port.db"), "--model-path", str(tmp / "ce64"),
            "--out-dir", str(tmp / "port_tuned"), "--device", "cpu",
            *(f"--{k}={v}" for k, v in FEEDBACK_ARGS.items())]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_rerank.main(argv) == 0
    port = json.loads(out.getvalue().strip().splitlines()[-1])
    script = _jax_train_rerank_script()
    args = Namespace(feedback_db=str(tmp / "jax.db"), model_path=str(tmp / "ce64"),
                     out_dir=str(tmp / "jax_tuned"), **FEEDBACK_ARGS)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert script.finetune_from_feedback(args, None, mesh, False) == 0
    jax_line = json.loads(out.getvalue().strip().splitlines()[-1])
    return tmp, port, jax_line


def test_feedback_finetune_at_head_dim_64_matches_the_jax_script(tuned_rerankers):
    """The same mined groups and steps; loss_first and loss_last within
    2e-4 of the JAX script's (which rounds them to 4 decimals, 5e-5; the
    two packages' f32 steps agree within 1e-5 each,
    tests/test_torch_training.py); each leaf's movement over the three
    AdamW steps within 5e-3 of the JAX movement's norm plus two f32 ulps of
    the values, and the weights moved. As in
    test_two_steps_match_the_jax_steps, Adam divides by sqrt(v), so an
    element whose gradients nearly cancel moves by a part of lr that f32
    rounding sets (three steps here: up to 1.8e-3 of a leaf's norm, the
    pooler bias; a wrong or lost gradient moves it by O(1)), and the
    leaves whose gradient is zero up to rounding are left out (k_b; the
    classifier bias under the listwise loss)."""
    tmp, port, jline = tuned_rerankers
    assert port["mode"] == jline["mode"] == "feedback"
    assert (port["triples"], port["groups"], port["steps"]) == (
        jline["triples"], jline["groups"], jline["steps"]) == (12, 6, 3)
    for key in ("loss_first", "loss_last"):
        assert abs(port[key] - jline[key]) <= 2e-4, (key, port[key], jline[key])
    got, want, start = (np.load(tmp / d / "model.npz") for d in ("port_tuned", "jax_tuned", "ce64"))
    assert set(got.files) == set(want.files)
    moved = 0.0
    for name in want.files:
        if name.endswith("k_b") or name == "classifier/b":
            continue
        p0 = start[name]
        step, jstep = got[name] - p0, want[name] - p0
        ulps = 2 * np.linalg.norm(np.spacing(np.abs(p0) + 1e-3 * 2))   # f32 storage
        assert np.linalg.norm(step - jstep) <= 5e-3 * np.linalg.norm(jstep) + ulps, name
        moved = max(moved, float(np.abs(step).max()))
    assert moved > 1e-4
    cfg = json.loads((tmp / "port_tuned" / "config.json").read_text())
    assert (cfg["hidden_size"], cfg["num_attention_heads"]) == (128, 2)


@pytest.fixture(scope="module")
def tuned_runtimes(tuned_rerankers, tmp_path_factory):
    """The port's tuned checkpoint as the reranker of both packages'
    runtimes on the CPU, beside small seeded encoders, over CORPUS."""
    tmp, port, _ = tuned_rerankers
    work = tmp_path_factory.mktemp("tuned_serve")
    mp = pytest.MonkeyPatch()
    mp.delenv("FRAG_PLATFORM", raising=False)
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(work / "jax_cache"))
    ckpt = work / "ckpt"
    _write_checkpoint(ckpt / "bge-base", CROSS, seed=51)
    _write_checkpoint(ckpt / "gte-base", CROSS, seed=52)
    src = work / "src"
    src.mkdir()
    for doc_id, text in CORPUS.items():
        (src / f"{doc_id}.json").write_text(json.dumps({"blocks": [{"content": text, "page": 0}]}))
    runtimes = []
    for cls, rt_cls, kw in ((JaxFrameworkConfig, JaxRuntime, {}),
                            (FrameworkConfig, Runtime, {"device": "cpu"})):
        cfg = _config(cls, ckpt)
        cfg.rerank.model_path = port["checkpoint"]
        rt = rt_cls.build(cfg, data_dir=work / cls.__module__.split(".")[0], **kw)
        for doc_id in CORPUS:
            f = src / f"{doc_id}.json"
            assert "error" not in rt.pipeline.ingest_extracted_json(
                f, doc_id, source_path=str(f), source_mtime=0.0)
        runtimes.append(rt)
    yield runtimes
    mp.undo()


@pytest.mark.parametrize("question", GOLDEN)
def test_tuned_reranker_serves_in_the_port_as_in_jax(tuned_runtimes, question):
    """The checkpoint the port's feedback fine-tune wrote (2 heads of 64)
    loads in the port's runtime as its cross-encoder and ranks as the JAX
    runtime does with the same checkpoint: the same top children, in
    order, and the same answer."""
    jrt, trt = tuned_runtimes
    model = getattr(trt.engine.reranker.model, "inner", trt.engine.reranker.model)
    assert model.config.hidden_size == 128 and model.config.num_heads == 2
    jout, tout = jrt.engine.query(question), trt.engine.query(question)
    assert jout["success"] and tout["success"]
    ttexts = [c["text"] for c in tout["top_children_chunks"]]
    assert ttexts and ttexts == [c["text"] for c in jout["top_children_chunks"]]
    assert tout["answer"] == jout["answer"]
