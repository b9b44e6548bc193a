"""The port's flat and IVF sweeps (K5-K8) against the JAX package's Pallas
kernels in interpret mode.

Each plain PyTorch version (the CPU path of its wrapper, and the oracle the
CUDA kernel is held against on the GPU) gets the same numpy inputs as the
JAX function. On exact-grid data every score and tie is exact, so ids and
scores must agree bit for bit, empty slots included; on real-valued data the
f32 sums differ in order, so scores agree within 1e-5 (int8 sums are exact
integers, so there ids and scores agree exactly).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from financial_rag_tpu.ops import ivf_probe as jax_ivf_probe
from financial_rag_tpu.ops import topk as jax_topk
from financial_rag_tpu_torch.ops import ivf_probe, topk

torch.set_num_threads(2)

SWEEPS = {
    # name: (JAX function, plain version, keyword arguments)
    "bucketed_topk_fused": (jax_topk.bucketed_topk_fused, topk.bucketed_topk_fused_plain,
                            {"nbuckets": 2048}),
    "bucketed_topk": (jax_topk.bucketed_topk, topk.bucketed_topk_plain, {"nbuckets": 2048}),
    "topk_matmul": (jax_topk.topk_matmul, topk.topk_matmul_plain, {}),
}


def _grid(rng, shape):
    """Coordinates on a 1/16 grid: every dot product is exact in f32."""
    return rng.integers(-3, 4, shape).astype(np.float32) / 16.0


def _corpus(x, valid, dtype):
    """The same corpus for both packages; int8 rows are integers with a
    per-row dequantization weight in the validity array."""
    if dtype == "int8":
        x8 = np.clip(np.round(x * 16), -127, 127)
        return (jnp.asarray(x8, jnp.int8), torch.from_numpy(x8).to(torch.int8),
                valid * np.float32(0.01))
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype)), valid


def _case(name):
    rng = np.random.default_rng(11)
    n = 1024 if name == "one_tile" else 4096
    q, x = _grid(rng, (7, 64)), _grid(rng, (n, 64))
    valid = np.ones(n, np.float32)
    if name == "dead_slots":
        valid[rng.choice(n, 1500, replace=False)] = 0.0
    if name == "few_live":              # fewer live rows than k, spread over tiles
        valid[:] = 0.0
        valid[[3, 1500, 2100, 4000]] = 1.0
    if name == "all_dead":
        valid[:] = 0.0
    if name == "ties":
        x[1024:2048] = x[:1024]         # tile 0 repeated in tile 1
        x[2048 + 5] = x[5]              # and in the next round of buckets
        x[70] = x[5]                    # and within tile 0
    return q, x, valid


def _run_both(name, q, x, valid, dtype, k=24):
    jax_fn, plain, kw = SWEEPS[name]
    jx, tx, v = _corpus(x, valid, dtype)
    ref_s, ref_i = jax_fn(jnp.asarray(q), jx, jnp.asarray(v), k, interpret=True, **kw)
    out_s, out_i = plain(torch.from_numpy(q), tx, torch.from_numpy(v), k, **kw)
    return (np.asarray(ref_s), np.asarray(ref_i)), (out_s.numpy(), out_i.numpy())


@pytest.mark.parametrize("name", list(SWEEPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["one_tile", "dead_slots", "few_live", "all_dead", "ties"])
def test_sweep_plain_matches_pallas_exactly(name, dtype, case):
    q, x, valid = _case(case)
    (ref_s, ref_i), (out_s, out_i) = _run_both(name, q, x, valid, dtype)
    np.testing.assert_array_equal(out_i, ref_i)
    np.testing.assert_array_equal(out_s, ref_s)
    if case == "ties" and name == "topk_matmul":
        # equal scores resolve toward the lower corpus index
        assert (ref_i < 1024).any()


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_empty_slot_contracts(name):
    """Fewer live rows than k: each JAX kernel leaves its own mark in the
    empty slots, and the plain version keeps it (the downstream filter drops
    them by score)."""
    q, x, valid = _case("few_live")
    (ref_s, ref_i), (out_s, out_i) = _run_both(name, q, x, valid, "float32")
    assert (ref_s[:, 4:] == topk.NEG).all()
    np.testing.assert_array_equal(out_i, ref_i)
    empty_ids = set(ref_i[:, 4:].ravel().tolist())
    if name == "bucketed_topk":
        assert empty_ids == {-1}
    elif name == "bucketed_topk_fused":          # bucket 0's index: row 0 is dead -> -1
        assert empty_ids == {-1}
    else:                                        # best live row outside the last tile
        assert empty_ids <= {3, 1500, 2100}


@pytest.mark.parametrize("name", list(SWEEPS))
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sweep_plain_matches_pallas_on_unit_vectors(name, dtype):
    rng = np.random.default_rng(12)
    n, d = 4096, 64
    q = rng.standard_normal((9, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.ones(n, np.float32)
    valid[::7] = 0.0
    if dtype == "int8":      # the index's own per-row quantization (_corpus undoes the /16)
        m = np.abs(x).max(axis=1)
        x = np.clip(np.round(x * (127.0 / m[:, None])), -127, 127) / 16.0
        valid = valid * (m / 127.0) / np.float32(0.01)
    (ref_s, ref_i), (out_s, out_i) = _run_both(name, q, x, valid, dtype)
    if dtype == "int8":
        np.testing.assert_array_equal(out_i, ref_i)
        np.testing.assert_allclose(out_s, ref_s, atol=1e-6, rtol=0)
    else:
        assert (out_i == ref_i).mean() >= 0.99
        np.testing.assert_allclose(out_s, ref_s, atol=1e-5, rtol=0)


def test_bucketed_sweeps_are_exact_when_the_corpus_fits_the_buckets():
    """N <= nbuckets: every column is its own bucket (nbuckets drops to N)."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2048, 64)).astype(np.float32))
    valid = torch.ones(2048)
    exact = topk.topk_matmul_plain(q, x, valid, 24)
    for fn in (topk.bucketed_topk_plain, topk.bucketed_topk_fused_plain):
        got = fn(q, x, valid, 24, nbuckets=4096)
        assert torch.equal(got[1], exact[1]) and torch.equal(got[0], exact[0])


def test_int8_scale_applies_to_live_scores_only():
    """Quantized unit vectors: live scores come back in cosine range (the
    row weight and the query scale undo both quantizations); empty slots stay
    at NEG."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    v = rng.standard_normal((1024, 64)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    m = np.abs(v).max(axis=1)
    x = torch.from_numpy(np.round(v * (127.0 / m[:, None]))).to(torch.int8)
    valid = torch.zeros(1024)
    valid[:5] = torch.from_numpy(m[:5] / 127.0)
    cos = torch.from_numpy(v[:5]) @ (q / q.norm(dim=1, keepdim=True)).T       # [5, 3]
    for name, (_, plain, kw) in SWEEPS.items():
        s, i = plain(q, x, valid, 8, **kw)
        assert (s[:, 5:] == topk.NEG).all(), name
        want = cos.T.gather(1, i[:, :5].long())
        torch.testing.assert_close(s[:, :5] / q.norm(dim=1, keepdim=True), want,
                                   atol=0.05, rtol=0)


@pytest.mark.parametrize("nchunks,qtiles,k,per_group", [(800, 2, 24, 5), (800, 2, 128, 25),
                                                        (128, 2, 24, 1), (8, 1, 24, 1),
                                                        (3200, 1, 24, 19)])
def test_exact_sweep_chunk_groups(nchunks, qtiles, k, per_group):
    """About eight blocks per SM (132 SMs), at most 4096 list entries for the
    merge, never less than one 128-column chunk per group."""
    assert topk.exact_groups(nchunks, qtiles, k, sms=132) == per_group


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_probe_plain_matches_pallas_and_reference(dtype):
    rng = np.random.default_rng(15)
    nlist, ls, d, b, p = 8, 128, 64, 5, 3
    if dtype == "int8":
        storage = rng.integers(-127, 128, (nlist, ls, d)).astype(np.float32)
        q = rng.integers(-127, 128, (b, d)).astype(np.float32)
        jdt, tdt = jnp.int8, torch.int8
        weights = np.full((nlist, ls), 1.0 / 127.0, np.float32)
    else:
        storage = _grid(rng, (nlist, ls, d))
        q = _grid(rng, (b, d))
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        weights = np.ones((nlist, ls), np.float32)
    weights[:, 100:] = 0.0
    weights[2, :] = 0.0
    probes = rng.integers(0, nlist, (b, p)).astype(np.int32)
    probes[0] = [2, 2, 5]                                 # a repeated and an empty list
    jargs = (jnp.asarray(q, jdt), jnp.asarray(storage, jdt), jnp.asarray(weights),
             jnp.asarray(probes))
    pallas = np.asarray(jax_ivf_probe.probe_scores(*jargs, interpret=True))
    reference = np.asarray(jax_ivf_probe.probe_scores_reference(*jargs))
    before = ivf_probe.LAUNCHES
    out = ivf_probe.probe_scores(torch.from_numpy(q).to(tdt), torch.from_numpy(storage).to(tdt),
                                 torch.from_numpy(weights), torch.from_numpy(probes))
    assert ivf_probe.LAUNCHES == before                  # the CPU takes the plain version
    assert out.shape == (b, p, ls) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), pallas)
    np.testing.assert_array_equal(out.numpy(), reference)
    assert (out.numpy()[0, :2] == -1.0e5).all()
