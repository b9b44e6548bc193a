"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (the CPU path of its wrapper, and the oracle the
CUDA kernel is held against on the GPU) runs on the same numpy inputs as the
JAX kernel in interpret mode. The wrappers must dispatch CPU tensors to the
plain version without touching their launch counters, and must never hand
a non-CPU tensor to it.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from financial_rag_tpu.ops import flash_attention as jax_flash_attention
from financial_rag_tpu.ops import masked_mean_l2_normalize as jax_pool_norm
from financial_rag_tpu.ops import packed_topk_fused as jax_packed_topk_fused
from financial_rag_tpu.ops import topk_matmul_reference as jax_topk_matmul_reference
from financial_rag_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.ops import fused_ffn as ffn
from financial_rag_tpu_torch.ops import ivf_probe
from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops import pool_norm as pn
from financial_rag_tpu_torch.ops import topk

torch.set_num_threads(2)

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(x: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor (bf16 rounding is
    round-to-nearest-even in both)."""
    return jnp.asarray(x, JAX_DT[dtype]), torch.from_numpy(np.ascontiguousarray(x)).to(TORCH_DT[dtype])


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# --------------------------------------------------------------------- K1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_norm_plain_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    b, s, h = 5, 64, 128       # b not a multiple of the Pallas block (8): padded batch
    hidden = rng.standard_normal((b, s, h)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, 10:] = 0
    mask[3, 1:] = 0
    mask[4, 40:] = 0
    jh, th = _both(hidden, dtype)
    ref = np.asarray(jax_pool_norm(jh, jnp.asarray(mask), interpret=True))
    out = pn.masked_mean_l2_normalize_plain(th, torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (b, h)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


# --------------------------------------------------------------------- K2


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_flash_attention_plain_matches_pallas(dtype, atol):
    rng = np.random.default_rng(2)
    b, s, h, heads = 3, 64, 64, 4
    q, k, v = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, 20:] = 0            # padded row
    mask[2, :] = 0              # fully masked row
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    ref = jax_flash_attention(jq, jk, jv, jnp.asarray(bias.reshape(b, 1, 1, s)),
                              num_heads=heads, interpret=True)
    out = fa.flash_attention_plain(tq, tk, tv, torch.from_numpy(bias), num_heads=heads)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (b, s, h)
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol)


def test_flash_attention_fully_masked_row_is_mean_of_v():
    """Every score of a fully masked row is -1e9: the softmax is uniform and
    the row's output is the mean of v, a defined value (no NaN)."""
    rng = np.random.default_rng(3)
    b, s, h, heads = 1, 64, 64, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32))
               for _ in range(3))
    bias = torch.full((b, s), -1e9)
    out = fa.flash_attention_plain(q, k, v, bias, num_heads=heads)
    expect = v.mean(dim=1, keepdim=True).expand(b, s, h)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), atol=1e-5)


# --------------------------------------------------------------------- K3


def _ffn_inputs(seed=4, n=100, h=64, i=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    w1 = (rng.standard_normal((h, i)) / np.sqrt(h)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(i)).astype(np.float32)
    w2 = (rng.standard_normal((i, h)) / np.sqrt(i)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, w1, b1, w2, b2


def _gelu_gap() -> float:
    """max |gelu_tanh(v) - gelu_erf(v)| over the real line (a dense grid)."""
    v = np.linspace(-12, 12, 480001)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=False), np.float64)
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=True), np.float64)
    return float(np.abs(exact - tanh).max())


def test_fused_ffn_plain_vs_pallas_within_gelu_gap():
    """The TPU kernel's tanh GELU vs the port's exact erf GELU: each output
    may move by at most gap * ||W2[:, j]||_1 (the gap is ~1e-3 at most)."""
    x, w1, b1, w2, b2 = _ffn_inputs()
    ref = np.asarray(jax_fused_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                                   interpret=True))
    out = ffn.fused_ffn_plain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2))).numpy()
    gap = _gelu_gap()
    assert 1e-4 < gap < 2e-3
    bound = gap * np.abs(w2).sum(axis=0) + 1e-5      # per output column
    assert np.all(np.abs(out - ref) <= bound[None, :])
    # and the difference is real: the port does not compute tanh GELU
    assert np.abs(out - ref).max() > 1e-6


def test_fused_ffn_plain_matches_xla_ffn():
    """Against the JAX package's own non-TPU FFN (models/bert.py, erf GELU)."""
    x, w1, b1, w2, b2 = _ffn_inputs(seed=5)
    jx, jw1, jb1, jw2, jb2 = (jnp.asarray(a) for a in (x, w1, b1, w2, b2))
    hh = jnp.dot(x, jw1, preferred_element_type=jnp.float32) + jb1
    hh = jax.nn.gelu(hh, approximate=False)
    ref = np.asarray(jnp.dot(hh, jw2, preferred_element_type=jnp.float32) + jb2)
    out = ffn.fused_ffn_plain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("tiles,chunks,sms,splits", [
    (1, 48, 132, 12), (2, 48, 132, 12), (4, 48, 132, 12), (8, 48, 132, 12), (33, 48, 132, 4),
    (64, 48, 132, 3), (128, 48, 132, 2), (132, 48, 132, 1), (256, 48, 132, 1),
    (1024, 48, 132, 1), (16, 48, 114, 8), (4, 16, 132, 4)])
def test_fused_ffn_split_count(tiles, chunks, sms, splits):
    """The I axis (48 chunks of 32 at I=1,536) is split just far enough to
    give each SM a block of 128 tokens, but no split leaves a block fewer
    than KERNEL_MIN_CHUNKS (4) chunks: a query's 4 tiles take 12 splits,
    not 48 (each split writes and reads back an f32 partial of its tile)."""
    assert ffn.KERNEL_TOKENS == 128 and ffn.KERNEL_MIN_CHUNKS == 4
    assert ffn.split_count(tiles, chunks=chunks, sms=sms) == splits


# --------------------------------------------------------------------- K4


def _grid_unit(rng, shape):
    """Coordinates on a 1/16 grid: every dot product of length 32 is exact
    in f32 (and bf16 storage is exact), so scores and ties agree bit for bit
    whatever the summation order."""
    return (rng.integers(-3, 4, size=shape) / 16.0).astype(np.float32)


def _packed_case(name):
    rng = np.random.default_rng(6)
    d = 32
    if name == "one_tile":
        n, nq = 1024, 5
    else:
        n, nq = 4096, 7              # 4 tiles -> bits = 2
    q = _grid_unit(rng, (nq, d))
    x = _grid_unit(rng, (n, d))
    valid = np.ones(n, np.float32)
    if name == "dead_slots":
        valid[rng.choice(n, 1500, replace=False)] = 0.0
    if name == "all_dead":
        valid[:] = 0.0
    if name == "ties":
        x[1024:2048] = x[:1024]      # every row of tile 0 repeated in tile 1
        x[3000] = x[5]               # and one more copy, another bucket
        x[70] = x[5]                 # and one in tile 0 itself
    return q, x, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one_tile", "four_tiles", "dead_slots", "all_dead", "ties"])
def test_packed_topk_plain_matches_pallas(case, dtype):
    q, x, valid = _packed_case(case)
    k = 24
    jq, tq = _both(q)
    jx, tx = _both(x, dtype)
    ref_s, ref_i = jax_packed_topk_fused(jq, jx, jnp.asarray(valid), k, interpret=True)
    out_s, out_i = topk.packed_topk_fused_plain(tq, tx, torch.from_numpy(valid), k)
    ref_i = np.asarray(ref_i)
    np.testing.assert_array_equal(out_i.numpy(), ref_i)
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
    if case == "all_dead":
        assert (ref_i == -1).all()
    if case == "ties":
        # the contract resolves equal scores toward the earlier tile
        assert (ref_i < 1024).any() and len(set(ref_i[0])) == k


def test_packed_topk_plain_matches_pallas_on_unit_vectors():
    """Real-valued unit vectors: ids identical, scores within one quantum."""
    rng = np.random.default_rng(7)
    n, d, nq, k = 4096, 64, 9, 24
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.ones(n, np.float32)
    valid[::7] = 0.0
    ref_s, ref_i = jax_packed_topk_fused(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), k,
                                         interpret=True)
    out_s, out_i = topk.packed_topk_fused_plain(torch.from_numpy(q), torch.from_numpy(x),
                                                torch.from_numpy(valid), k)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    quantum = 2.0 ** (2 - 22)    # bits = 2 low mantissa bits of p in [2, 4)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), atol=quantum + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_topk_matmul_reference_matches_jax(dtype):
    rng = np.random.default_rng(8)
    n, d, nq, k = 4096, 32, 6, 24
    q = _grid_unit(rng, (nq, d))
    x = _grid_unit(rng, (n, d))
    x[2048:2100] = x[:52]                      # ties across chunks
    valid = np.ones(n, np.float32)
    valid[100:3000] = 0.0
    if dtype == "int8":
        x8 = np.clip(np.round(x * 16), -127, 127)
        jx, tx = jnp.asarray(x8, jnp.int8), torch.from_numpy(x8).to(torch.int8)
        valid = valid * 0.01                   # per-row dequant weights
    else:
        jx, tx = _both(x, dtype)
    ref_s, ref_i = jax_topk_matmul_reference(jnp.asarray(q), jx, jnp.asarray(valid), k, chunk=1024)
    out_s, out_i = topk.topk_matmul_reference(torch.from_numpy(q), tx, torch.from_numpy(valid),
                                              k, chunk=1024)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ntiles,base,per_group", [(100, 128, 12), (100, 64, 6), (4, 64, 1),
                                                  (1, 64, 1), (16, 2048, 16)])
def test_packed_topk_tile_groups(ntiles, base, per_group):
    """The sweep splits its corpus tiles into groups until ~8 blocks per SM
    (132 SMs) are in flight, never below one tile per group."""
    assert topk.tile_groups(ntiles, base, sms=132) == per_group


def test_topk_matmul_reference_fewer_live_than_k():
    rng = np.random.default_rng(9)
    q, x = _grid_unit(rng, (3, 32)), _grid_unit(rng, (1024, 32))
    valid = np.zeros(1024, np.float32)
    valid[[5, 900]] = 1.0
    ref_s, ref_i = jax_topk_matmul_reference(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), 8)
    out_s, out_i = topk.topk_matmul_reference(torch.from_numpy(q), torch.from_numpy(x),
                                              torch.from_numpy(valid), 8)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
    assert (out_i.numpy()[:, 2:] == -1).all()


# ------------------------------------------------------- wrappers on the CPU


def _cpu_calls():
    rng = np.random.default_rng(10)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    mask = torch.ones(2, 64, dtype=torch.int32)
    mask[1, 30:] = 0
    bias = torch.where(mask > 0, 0.0, -1e9)
    q, x = torch.from_numpy(_grid_unit(rng, (3, 32))), torch.from_numpy(_grid_unit(rng, (2048, 32)))
    valid = torch.ones(2048)
    w = [t(64, 128), t(128), t(128, 64), t(64)]
    h = t(2, 64, 64)
    storage, weights = t(4, 128, 32), torch.ones(4, 128)
    probes = torch.tensor([[0, 3], [2, 2], [1, 0]])
    return [
        (pn, lambda: pn.masked_mean_l2_normalize(h, mask),
         lambda: pn.masked_mean_l2_normalize_plain(h, mask)),
        (fa, lambda: fa.flash_attention(h, h, h, bias, num_heads=4),
         lambda: fa.flash_attention_plain(h, h, h, bias, num_heads=4)),
        (ffn, lambda: ffn.fused_ffn(h, *w), lambda: ffn.fused_ffn_plain(h, *w)),
        (topk, lambda: topk.packed_topk_fused(q, x, valid, 10),
         lambda: topk.packed_topk_fused_plain(q, x, valid, 10)),
        (topk, lambda: topk.bucketed_topk_fused(q, x, valid, 10),
         lambda: topk.bucketed_topk_fused_plain(q, x, valid, 10)),
        (topk, lambda: topk.topk_matmul(q, x, valid, 10),
         lambda: topk.topk_matmul_plain(q, x, valid, 10)),
        (topk, lambda: topk.bucketed_topk(q, x, valid, 10),
         lambda: topk.bucketed_topk_plain(q, x, valid, 10)),
        (ivf_probe, lambda: ivf_probe.probe_scores(q, storage, weights, probes),
         lambda: ivf_probe.probe_scores_plain(q, storage, weights, probes)),
    ]


@pytest.mark.parametrize("pos", range(8), ids=["pool_norm", "flash_attention", "fused_ffn",
                                                "packed_topk", "bucketed_topk_fused",
                                                "topk_matmul", "bucketed_topk", "probe_scores"])
def test_cpu_wrapper_runs_plain_and_counts_nothing(pos):
    mod, wrapped, plain = _cpu_calls()[pos]
    before = copy.copy(mod.LAUNCHES)
    got, want = wrapped(), plain()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert mod.LAUNCHES == before


def test_non_cpu_tensor_never_reaches_the_plain_version():
    """A tensor that is on neither the CPU nor a CUDA device raises: the
    wrappers launch the kernel or raise, they never fall back."""
    meta = dict(device="meta")
    h = torch.empty(2, 64, 384, dtype=torch.bfloat16, **meta)
    mask = torch.ones(2, 64, **meta)
    w1, b1 = torch.empty(384, 1536, dtype=torch.bfloat16, **meta), torch.empty(1536, dtype=torch.bfloat16, **meta)
    w2, b2 = torch.empty(1536, 384, dtype=torch.bfloat16, **meta), torch.empty(384, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        pn.masked_mean_l2_normalize(h, mask)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(h, h, h, mask, num_heads=12)
    with pytest.raises(ValueError, match="CUDA"):
        ffn.fused_ffn(h, w1, b1, w2, b2)
    x, valid = h[1].repeat(16, 1), torch.ones(1024, **meta)
    for sweep in (topk.packed_topk_fused, topk.bucketed_topk_fused, topk.bucketed_topk,
                  topk.topk_matmul):
        with pytest.raises(ValueError, match="CUDA"):
            sweep(h[0], x, valid, 24)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_probe.probe_scores(h[0], x.view(8, 128, 384), valid.view(8, 128),
                               torch.zeros(64, 3, dtype=torch.int32, **meta))


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAG_KERNEL_BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_lib.build()
    assert kernel_lib._lib is None


def test_first_split_exp_of_a_fresh_process_is_accurate():
    """A fresh process that imports the ops package and then runs torch's
    float exp across two intra-op threads gets every element within 1e-6
    of the f64 exp (the package sets MKL up on one thread first). Several
    processes at once, as the test workers start: without that set-up the
    second thread's half came out at ~1.5e-4 in about 6% of fresh
    processes under load."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import torch, financial_rag_tpu_torch.ops\n"
            "torch.set_num_threads(2)\n"
            "x = torch.linspace(-16, 16, 65536)\n"
            "ref = torch.exp(x.double())\n"
            "print(((torch.exp(x).double() - ref).abs() / ref).max().item())\n")
    root = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert float(out.strip()) <= 1e-6, out
