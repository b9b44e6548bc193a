"""The bge-large width (hidden 1,024, 16 heads of 64, FFN 4,096, index D
1,024) in the port against the JAX package.

Each plain PyTorch version the kernels are held against on the card at this
width (K1 at H 1,024, K2 at 16 heads of 64, K3's third design, K4, K5 and
K7 at D 1,024, K8 at D 1,024) runs on the same numpy inputs as the JAX
function, with Pallas in interpret mode; K3's and the sweeps' launch plans
at 1,024 are checked against the CUDA sources' constants; the width checks
take the bge-large shape on CUDA and still refuse what no kernel takes; and
a 2-layer bge-large-shape runtime in the port answers the golden questions
as the JAX runtime does.
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
from financial_rag_tpu.ops import masked_mean_l2_normalize as jax_pool_norm
from financial_rag_tpu.ops import packed_topk_fused as jax_packed_topk_fused
from financial_rag_tpu.ops import topk as jax_topk
from financial_rag_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from financial_rag_tpu.ops.ivf_probe import probe_scores as jax_probe_scores
from financial_rag_tpu.runtime import Runtime as JaxRuntime
from financial_rag_tpu_torch.config import FrameworkConfig, ModelConfig
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.ops import fused_ffn as ffn
from financial_rag_tpu_torch.ops import ivf_probe
from financial_rag_tpu_torch.ops import pool_norm as pn
from financial_rag_tpu_torch.ops import topk
from financial_rag_tpu_torch.runtime import Runtime, check_supported
from financial_rag_tpu_torch.training import contrastive, rerank_ft

torch.set_num_threads(2)

H100_SMS = 132
CSRC = Path(ffn.__file__).resolve().parents[1] / "csrc"


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _grid(rng, shape):
    """Coordinates on a 1/16 grid: every dot of 1,024 features is a multiple
    of 2^-8 far below 2^24 of them, exact in f32 (and in bf16 storage)
    whatever the summation order."""
    return (rng.integers(-3, 4, size=shape) / 16.0).astype(np.float32)


def _cuda_constants(name: str) -> dict:
    """A CUDA source's top-level ``constexpr int`` constants, evaluated in order."""
    env = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", (CSRC / name).read_text(), re.M):
        env[key] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


# --------------------------------------------------------------- K1, K2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_norm_plain_matches_pallas_at_hidden_1024(dtype):
    """gte-large's mean pooling at H = 1,024, a padded row and a fully
    masked one, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(51)
    b, s, h = 5, 40, 1024
    hidden = rng.standard_normal((b, s, h)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, 17:] = 0
    mask[4] = 0
    jh = jnp.asarray(hidden, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    th = torch.from_numpy(hidden).to(getattr(torch, dtype))
    ref = np.asarray(jax_pool_norm(jh, jnp.asarray(mask), interpret=True))
    out = pn.masked_mean_l2_normalize_plain(th, torch.from_numpy(mask))
    assert out.shape == (b, h)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    assert (out[4] == 0).all()


def test_flash_attention_plain_matches_pallas_at_16_heads_of_64():
    """bge-large's attention: 16 heads of 64 (h = 1,024), S = 64, a padded
    row and a fully masked one, f32, against the Pallas kernel."""
    rng = np.random.default_rng(52)
    b, s, h, heads = 3, 64, 1024, 16
    q, k, v = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, 40:] = 0
    mask[2] = 0
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    ref = jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(bias.reshape(b, 1, 1, s)), num_heads=heads,
                              interpret=True)
    out = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(bias), num_heads=heads)
    assert out.shape == (b, s, h)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


# --------------------------------------------------------------------- K3


def _gelu_gap() -> float:
    v = np.linspace(-12, 12, 480001)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=False), np.float64)
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=True), np.float64)
    return float(np.abs(exact - tanh).max())


@pytest.mark.parametrize("n", [129, 300])
def test_fused_ffn_plain_vs_pallas_at_hidden_1024_within_gelu_gap(n):
    """Token counts that are no multiple of any tile at H = 1,024, I =
    4,096: the TPU kernel's tanh GELU against the port's erf GELU, each
    output within gap * ||W2[:, j]||_1 (+ f32 summation noise), the bar of
    test_fused_ffn_plain_vs_pallas_at_hidden_768_within_gelu_gap."""
    rng = np.random.default_rng(53)
    h, i = 1024, 4096
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


def test_k3_large_mirrors_equal_the_cuda_constants():
    """ops/fused_ffn.py's third design is csrc/fused_ffn.cu's: tiles of 128
    tokens by 256 (or 128) output columns, 64-deep ring stages (128-byte
    rows of the A tile, whole k16 steps), 4 (or 6) stages, staging tiles of
    128 output columns, two consumer warpgroups and a producer one, and
    split blocks of at least 4 k steps."""
    c = _cuda_constants("fused_ffn.cu")
    assert c["kGH"] == ffn.LARGE_HIDDEN == 1024
    assert (c["kGTokens"], c["kGDepth"]) == (ffn.LARGE_TOKENS, ffn.LARGE_DEPTH)
    assert (c["kGTokens"], c["kGDepth"]) == ffn.KERNEL_TILING[1024][:2]
    assert (c["kGWideCols"], c["kGNarrowCols"]) == (ffn.LARGE_WIDE_COLS, ffn.LARGE_NARROW_COLS)
    assert (c["kGWideStages"], c["kGNarrowStages"]) == (ffn.LARGE_WIDE_STAGES,
                                                        ffn.LARGE_NARROW_STAGES)
    assert c["kGThreads"] == ffn.LARGE_THREADS == 384
    assert c["kGOutCols"] == ffn.LARGE_OUT_COLS and c["kGStagingBytes"] == 64 * 128 * 2
    assert c["kGWideSmemBytes"] == ffn.large_smem_bytes(256)
    assert c["kGNarrowSmemBytes"] == ffn.large_smem_bytes(128)
    assert c["kGDepth"] * 2 == 128 and c["kGDepth"] % 16 == 0


@pytest.mark.parametrize("part", ["a_tile", "b_block", "staging_block"])
def test_k3_large_tiles_are_whole_swizzle_atoms(part):
    """Every shared-memory tile the design hands to wgmma or the TMA is
    whole 1,024-byte atoms of the 128-byte swizzle (8 rows of 128 bytes):
    the A tile (128 rows of 64 bf16 k), each 64-column block of the B tile
    (64 k rows) and each 64-column block of a staging tile (64 rows)."""
    c = _cuda_constants("fused_ffn.cu")
    size = {"a_tile": c["kGABytes"], "b_block": c["kGDepth"] * 128,
            "staging_block": c["kGStagingBytes"] // (c["kGOutCols"] // 64)}[part]
    assert size % 1024 == 0 and size // 128 % 8 == 0
    assert c["kGWideStageBytes"] % 1024 == 0 and c["kGNarrowStageBytes"] % 1024 == 0


@pytest.mark.parametrize("cols", [256, 128])
def test_k3_large_ring_fits_shared_memory(cols):
    """A stage is the 128 x 64 A tile (16 KB) and the 64 x cols B tile (32
    or 16 KB); 4 or 6 of them, the two consumer warpgroups' staging tiles
    of 64 x 128 bf16 outputs (16 KB each), the 1 KB alignment slack and
    the stages' full and empty barriers (static) within the 227 KB a
    block may take."""
    a_bytes, b_bytes, staging = 128 * 64 * 2, 64 * cols * 2, 64 * 128 * 2
    stages = ffn.LARGE_WIDE_STAGES if cols == 256 else ffn.LARGE_NARROW_STAGES
    smem = ffn.large_smem_bytes(cols)
    assert smem == stages * (a_bytes + b_bytes) + 2 * staging + 1024 == 230400
    assert smem + 2 * stages * 8 <= topk.SMEM_BLOCK_LIMIT
    assert ffn.block_smem_bytes(1024) == smem


@pytest.mark.parametrize("cols", [256, 128])
def test_k3_large_registers_fit_under_the_384_thread_cap(cols):
    """A consumer warpgroup's accumulator is its 64 rows by the tile's
    columns: 128 (or 64) f32 registers a thread, under the 168 that ptxas
    grants a thread of a 384-thread block, with room for the epilogue's
    bias pair and the descriptors and addresses (h is never held in
    registers: it is the first product's output tile); the setmaxnreg
    split (producer 40, consumers 232) fits the register file."""
    acc = 64 * cols // 128
    assert acc == (ffn.accumulator_registers(1024) if cols == 256 else 64)
    assert ffn.h_registers(1024) == 0
    cap = (65536 // ffn.LARGE_THREADS) // 8 * 8
    assert cap == 168
    assert acc + 2 + 2 * 2 + 16 <= cap
    assert 2 * 128 * 232 + 128 * 40 <= 65536


@pytest.mark.parametrize("n,plan", [(1, (128, 128, 16)), (512, (128, 128, 4)),
                                    (999, (256, 128, 2)), (2048, (256, 128, 1)),
                                    (34816, (256, 256, 1)), (131072, (256, 256, 1))])
def test_k3_large_launch_plan(n, plan):
    """(first product's tile columns, second's, splits) on 132 SMs at I =
    4,096: a query's 4 token tiles take 128-column tiles in both products
    (128 blocks each, one wave) and split the second product's 64 k steps
    4 ways; 999 tokens (8 tiles) fill a wave with 256-column tiles in the
    first; an ingest batch takes 256-column tiles and no split."""
    assert ffn.large_launch_plan(n, 4096, H100_SMS) == plan
    assert ffn.launch_plan(n, 1024, 4096, H100_SMS) == (128, 64, plan[2])
    up_cols, down_cols, splits = plan
    tiles = -(-n // 128)
    if n <= 999:
        assert tiles * (4096 // up_cols) <= H100_SMS
        assert tiles * (1024 // down_cols) * splits <= H100_SMS
    else:
        assert splits == 1 and tiles * (4096 // up_cols) >= H100_SMS


@pytest.mark.parametrize("n,expected", [(512, 4096 * 1024 + 4 * 512 * 4096),
                                        (34816, 285212672), (131072, 1073741824)])
def test_k3_large_scratch_bytes(n, expected):
    """The wrapper's device scratch: h [N, 4,096] bf16 (4.2 MB at 512
    tokens, 285 MB at the ingest's 34,816, 1.07 GB at 131,072) and, where
    the second product is split, its [splits, N, 1,024] f32 partials."""
    splits = ffn.large_launch_plan(n, 4096, H100_SMS)[2]
    assert ffn.large_scratch_bytes(n, 4096, splits) == expected
    assert ffn.large_scratch_bytes(n, 4096, 1) == n * 4096 * 2


@pytest.mark.parametrize("n", [1, 63, 129, 257, 512, 999, 1025, 2048, 4096, 17030])
@pytest.mark.parametrize("i_dim", [4096, 2048])
def test_k3_large_split_fits_one_wave_or_is_none(n, i_dim):
    """The second product splits its K axis only below one wave of
    256-column tiles; a split divides the I / 64 k steps, walks at least
    4 of them, and is the most that keep the grid in one wave."""
    up_cols, down_cols, splits = ffn.large_launch_plan(n, i_dim, H100_SMS)
    tiles, steps = -(-n // 128), i_dim // 64
    assert up_cols in (128, 256) and down_cols in (128, 256)
    assert steps % splits == 0 and (splits == 1 or steps // splits >= ffn.LARGE_MIN_STEPS)
    if tiles * 4 >= H100_SMS:
        assert (down_cols, splits) == (256, 1)
    else:
        units = tiles * (1024 // down_cols)
        assert units * splits <= H100_SMS or splits == 1
        more = [d for d in range(splits + 1, steps // ffn.LARGE_MIN_STEPS + 1) if steps % d == 0]
        assert all(units * d > H100_SMS for d in more)


# ------------------------------------------------------------- K4, K5, K7


def _large_corpus(case):
    """7 queries over 4,096 rows of D = 1,024 on the exact grid, with dead
    slots or repeated rows (ties within a tile, across tiles and across
    bucket rounds)."""
    rng = np.random.default_rng(54)
    n, d = 4096, 1024
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
def test_packed_topk_plain_matches_pallas_at_d1024(case, dtype):
    q, x, valid = _large_corpus(case)
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref_s, ref_i = jax_packed_topk_fused(jnp.asarray(q), jx, jnp.asarray(valid), 24,
                                         interpret=True)
    out_s, out_i = topk.packed_topk_fused_plain(torch.from_numpy(q), tx,
                                                torch.from_numpy(valid), 24)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("name", ["bucketed_topk_fused", "bucketed_topk"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", ["plain", "dead_slots", "ties"])
def test_bucketed_sweeps_plain_match_pallas_at_d1024(name, case, dtype):
    """K5 (the int8 index's sweep) and K7 at D = 1,024, 2,048 buckets (two
    rounds): int8 rows are integers with a per-row weight, bf16 rows on the
    grid, so ids and scores agree bit for bit, dead slots and ties
    included."""
    q, x, valid = _large_corpus(case)
    if dtype == "int8":
        x8 = np.clip(np.round(x * 16), -127, 127)
        jx, tx = jnp.asarray(x8, jnp.int8), torch.from_numpy(x8).to(torch.int8)
        valid = valid * np.float32(0.01)
    else:
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    ref_s, ref_i = getattr(jax_topk, name)(jnp.asarray(q), jx, jnp.asarray(valid), 24,
                                           interpret=True, nbuckets=2048)
    out_s, out_i = getattr(topk, f"{name}_plain")(torch.from_numpy(q), tx,
                                                  torch.from_numpy(valid), 24, nbuckets=2048)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))


def test_int8_sweep_sums_stay_exact_at_d1024():
    """127 x 127 x 1,024 = 16,516,096 < 2^24 = 16,777,216: the int8 dot at
    the widest padded row is an integer an f32 holds exactly, as the plain
    version and the kernels' int32-to-f32 conversion both assume."""
    assert 127 * 127 * topk.SWEEP_MAX_D == 16_516_096 < 2 ** 24
    x = torch.full((4, 1024), 127, dtype=torch.int8)
    assert topk._tile_scores(x, -x)[0, 0].item() == -127 * 127 * 1024


def test_sweep_mirrors_equal_the_cuda_constants():
    """ops/topk.py's padded widths, tile rows and shared-memory budget are
    flat_sweep.cuh's; the tile rows follow its rule (32, or 16 where one
    warpgroup's queries leave room for fewer than 2 stages of 32 rows),
    which picks 16 for a bf16 row of 1,024 features alone."""
    c = _cuda_constants("flat_sweep.cuh")
    assert (c["kNarrowD"], c["kWideD"], c["kLargeD"]) == (
        topk.SWEEP_NARROW_D, topk.SWEEP_WIDE_D, topk.SWEEP_MAX_D)
    assert (c["kRows"], c["kSmemBudget"]) == (topk.SWEEP_ROWS, topk.SWEEP_SMEM_BUDGET)
    assert topk.PACKED_MAX_D == topk.SWEEP_MAX_D == 1024
    for d in (384, 768, 1024):
        for elem in (1, 2):
            row_bytes = d * elem
            regions = row_bytes // 128
            free = c["kSmemBudget"] - 1024 - regions * c["kRegionQ"]
            rows = c["kRows"] if free // (regions * c["kRows"] * 128) >= 2 else c["kRows"] // 2
            assert topk.sweep_rows(row_bytes) == rows == (16 if row_bytes == 2048 else 32)
    assert topk.packed_columns(1024) == 16 and topk.packed_columns(768) == 32


@pytest.mark.parametrize("bq,qtile", [(1, 64), (8, 64), (128, 64), (192, 64)])
def test_sweep_plans_at_d1024_fit_shared_memory(bq, qtile):
    """At D = 1,024 every sweep takes one query warpgroup: K4 and bf16
    K5/K7 a ring of 3 stages of 16 rows beside 128 KB of queries, int8
    K5/K7 5 stages of 32 rows beside 64 KB; each block within 227 KB with
    its static weights and barriers, and the grids fill the SMs once."""
    bqp, _, _, per_group, groups = topk.packed_sweep_grid(bq, 102400, H100_SMS, d=1024)
    assert topk.query_tile(bqp, 2 * 1024) == qtile
    stages, smem = topk.packed_sweep_smem(1024, qtile)
    assert stages == 3 >= 2 and smem == 230400
    assert smem + stages * (16 * 4 + 16) <= topk.SMEM_BLOCK_LIMIT
    assert (1024 // 16) * (bqp // qtile) * groups <= H100_SMS or groups == 1
    for elem, want_stages, rows in ((1, 5, 32), (2, 3, 16)):
        row_bytes = 1024 * elem
        bqp, _, groups = topk.bucketed_sweep_grid(bq, 102400, 4096, H100_SMS, row_bytes)
        assert topk.query_tile(bqp, row_bytes) == qtile
        stages, smem = topk.bucketed_sweep_smem(row_bytes, qtile)
        assert stages == want_stages >= 2 and smem <= topk.SWEEP_SMEM_BUDGET
        assert smem + stages * (rows * 4 + 16) <= topk.SMEM_BLOCK_LIMIT
        assert (4096 // rows) * (bqp // qtile) * groups <= 2 * H100_SMS or groups == 1


# --------------------------------------------------------------------- K8


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_probe_scores_plain_matches_pallas_at_d1024(dtype):
    """IVF probe scores at D = 1,024: 16 lists of 128 rows (the last 28 of
    each empty), 5 queries of 4 probes; int8 integer rows with weight
    1/127, bf16 rows on the grid: exact."""
    rng = np.random.default_rng(55)
    nlist, L, d, b, p = 16, 128, 1024, 5, 4
    weights = np.ones((nlist, L), np.float32)
    weights[:, 100:] = 0.0
    if dtype == "int8":
        st = rng.integers(-127, 128, size=(nlist, L, d)).astype(np.int8)
        q = rng.integers(-127, 128, size=(b, d)).astype(np.int8)
        weights *= np.float32(1.0 / 127.0)
        jst, tst = jnp.asarray(st), torch.from_numpy(st)
        jq, tq = jnp.asarray(q), torch.from_numpy(q)
    else:
        st, q = _grid(rng, (nlist, L, d)), _grid(rng, (b, d))
        jst, tst = jnp.asarray(st, jnp.bfloat16), torch.from_numpy(st).bfloat16()
        jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    probes = np.stack([rng.choice(nlist, p, replace=False) for _ in range(b)]).astype(np.int32)
    ref = np.asarray(jax_probe_scores(jq, jst, jnp.asarray(weights), jnp.asarray(probes),
                                      interpret=True))
    out = ivf_probe.probe_scores_plain(tq, tst, torch.from_numpy(weights),
                                       torch.from_numpy(probes))
    assert out.shape == (b, p, L)
    np.testing.assert_array_equal(out.numpy(), ref)


# ------------------------------------------------------------ width checks


def _encoder_dir(root: Path, name: str, hidden: int, heads: int, inter: int) -> str:
    d = root / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "hidden_size": hidden, "num_hidden_layers": 24, "num_attention_heads": heads,
        "intermediate_size": inter, "vocab_size": 30522, "max_position_embeddings": 512}))
    return str(d)


@pytest.mark.parametrize("kind,dtype,shards", [("flat", "bfloat16", 1), ("flat", "int8", 1),
                                               ("ivf", "bfloat16", 1), ("flat", "bfloat16", 4),
                                               ("flat", "int8", 4)])
def test_cuda_takes_bge_large_encoders_and_reranker(tmp_path, kind, dtype, shards):
    """bge-large / gte-large encoders and a bge-large-width reranker (hidden
    1,024, 24 layers, 16 heads of 64, FFN 4,096) pass check_supported on
    CUDA over a flat bf16 or int8 index (K4, K5), an IVF one (K8) and a
    sharded one (K7)."""
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = _encoder_dir(tmp_path, "bge-large", 1024, 16, 4096)
    cfg.encoders.gte_path = _encoder_dir(tmp_path, "gte-large", 1024, 16, 4096)
    cfg.rerank.model_path = _encoder_dir(tmp_path, "ce", 1024, 16, 4096)
    cfg.index.kind, cfg.index.dtype, cfg.mesh.index_shards = kind, dtype, shards
    check_supported(cfg, torch.device("cuda"))


@pytest.mark.parametrize("hidden,heads,inter,refused", [
    (1024, 8, 4096, r"flash_attention \(K2\) takes head_dim <= 64"),      # heads of 128
    (512, 16, 2048, None),                                                # K3's generic route
    (2048, 32, 8192, r"flat sweeps \(K4-K7\) take D <= 1024"),            # K3 takes 2,048 now
    (1024, 16, 4000, None),                                               # I not whole 64-steps
    (1020, 20, 4080, r"fused_ffn \(K3\) takes hidden and intermediate multiples of 8"),
])
def test_cuda_still_refuses_what_no_kernel_takes(tmp_path, hidden, heads, inter, refused):
    """K3 takes every hidden and intermediate width whose rows are whole
    16-byte chunks (512 / 2,048, 2,048 / 8,192 and 1,024 / 4,000 through its
    generic route); the rest is refused, naming the kernel: K2 above
    head_dim 64, the flat sweeps above D 1,024, K3 at hidden 1,020."""
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = _encoder_dir(tmp_path, "enc", hidden, heads, inter)
    cfg.encoders.gte_path = cfg.rerank.model_path = None
    check_supported(cfg, torch.device("cpu"))
    if refused is None:
        check_supported(cfg, torch.device("cuda"))
        return
    with pytest.raises(NotImplementedError, match=rf"baai: .*{refused}") as err:
        check_supported(cfg, torch.device("cuda"))
    assert ("fused_ffn (K3)" in str(err.value)) == (hidden % 8 != 0)


@pytest.mark.parametrize("maker", [contrastive.make_train_step, rerank_ft.make_rerank_train_step])
@pytest.mark.parametrize("hidden,heads,inter,refused", [(512, 16, 2048, False),
                                                        (1024, 16, 4096, False),
                                                        (1024, 16, 3000, False),
                                                        (100, 4, 400, True),
                                                        (1024, 16, 3004, True)])
def test_training_on_cuda_refuses_widths_k3_does_not_take(monkeypatch, maker, hidden, heads,
                                                          inter, refused):
    """make_train_step and make_rerank_train_step on a CUDA device refuse
    hidden 100 and I 3,004 at 1,024 (rows not whole 16-byte chunks) when
    the step is made, naming K3 (before, the check read K10's head_dim
    alone, and K3 raised in the middle of the first forward); the
    bge-large shape passes, and so do hidden 512 (I 2,048) and I 3,000 at
    1,024 on K3's generic route; the CPU builds a step at every width."""
    cfg = ModelConfig(hidden_size=hidden, num_layers=1, num_heads=heads,
                      intermediate_size=inter, vocab_size=64, max_position=32)
    module = contrastive if maker is contrastive.make_train_step else rerank_ft
    monkeypatch.setattr(module, "resolve_device", lambda device=None: torch.device("cuda"))
    if refused:
        with pytest.raises(NotImplementedError, match=rf"hidden {hidden} / intermediate "
                                                      rf"{inter}, but the feed-forward \(K3\)"):
            maker(cfg)
    else:
        contrastive.check_train_widths(cfg, torch.device("cuda"))
    monkeypatch.undo()
    _, init_state = maker(cfg, device="cpu")
    assert callable(init_state)


# -------------------------------------------- the runtime at the large shape

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
LARGE = dict(hidden_size=1024, num_layers=2, num_heads=16, intermediate_size=4096,
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
    cfg.encoders.baai_path = str(ckpt / "bge-large")
    cfg.encoders.gte_path = str(ckpt / "gte-large")
    cfg.rerank.model_path = str(ckpt / "ce")
    cfg.serving.microbatch = False
    cfg.llm.provider = "gemini"
    cfg.llm.gemini_api_key = None
    return cfg


@pytest.fixture(scope="module")
def large_runtimes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("large")
    mp = pytest.MonkeyPatch()
    mp.delenv("FRAG_PLATFORM", raising=False)
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
    ckpt = tmp / "ckpt"
    _write_checkpoint(ckpt / "bge-large", LARGE, seed=61)
    _write_checkpoint(ckpt / "gte-large", LARGE, seed=62)
    _write_checkpoint(ckpt / "ce", CROSS, seed=63, classifier=True)
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


def test_large_runtime_embeddings_match_jax(large_runtimes):
    """Both 1,024-wide encoders (baai CLS, gte mean pooling) on the same
    texts: the port's f32 CPU path within cosine 0.9999 of the JAX
    package's."""
    jrt, trt = large_runtimes
    texts = [*GOLDEN, *(t[:300] for t in CORPUS.values())]
    jv, tv = jrt.dual_encoder.encode_all(texts), trt.dual_encoder.encode_all(texts)
    assert set(tv) == {"baai", "gte"}
    for name in ("baai", "gte"):
        a, b = np.asarray(jv[name], np.float64), np.asarray(tv[name], np.float64)
        assert b.shape == (len(texts), 1024)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        assert cos.min() > 0.9999, (name, cos.min())


@pytest.mark.parametrize("question", GOLDEN)
def test_large_runtime_same_children_as_jax(large_runtimes, question):
    jrt, trt = large_runtimes
    assert {i.dim for i in trt.indexes.values()} == {1024}
    jout, tout = jrt.engine.query(question), trt.engine.query(question)
    assert jout["success"] and tout["success"]
    jtexts = [c["text"] for c in jout["top_children_chunks"]]
    ttexts = [c["text"] for c in tout["top_children_chunks"]]
    assert ttexts and ttexts == jtexts
    assert tout["answer"] == jout["answer"]
