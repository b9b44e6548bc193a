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


@pytest.mark.parametrize("bq,n,f32,plan", [
    (128, 102400, False, (128, 32, 49, 66)), (9, 4096, False, (64, 32, 1, 128)),
    (1, 1024, False, (64, 32, 1, 32)), (128, 16384, False, (128, 32, 8, 64)),
    (200, 102400, False, (256, 32, 97, 33)), (1, 102400, False, (64, 32, 25, 128)),
    (128, 102400, True, (128, 128, 2, 400)), (9, 4096, True, (64, 128, 1, 32)),
    (1, 102400, True, (64, 128, 1, 800))])
def test_exact_sweep_grid(bq, n, f32, plan):
    """(Bqp, rows_per_tile, tiles_per_group, groups) of K6 on 132 SMs: the
    int8/bf16 sweep's 64-query blocks of 32-row tiles fill the SMs once;
    the f32 sweep's 128-column steps keep ~8 blocks an SM in flight. The
    merge takes any number of groups (400 x 24 keys at the f32 table
    shape)."""
    assert topk.exact_sweep_grid(bq, n, sms=132, f32=f32) == plan


@pytest.mark.parametrize("dtype,groups,bqp,kcap,keys", [
    (torch.float32, 400, 128, 32, 400 * 128 * 32), (torch.bfloat16, 66, 128, 32, 66 * 128 * 224 + 4224),
    (torch.int8, 64, 128, 128, 64 * 128 * 256 + 4096), (torch.bfloat16, 1, 64, 32, 64 * 224 + 32)])
def test_exact_scratch_keys(dtype, groups, bqp, kcap, keys):
    """K6's scratch in int64 elements: the f32 sweep's [groups, Bqp, kcap]
    lists; the int8 / bf16 sweep's rows of 256 / 224 keys and then one int32
    length per (group, query) row, two to an element."""
    assert topk.exact_scratch_keys(dtype, groups, bqp, kcap) == keys


@pytest.mark.parametrize("bq,n,nbuckets,plan", [
    (128, 102400, 4096, (128, 25, 1)), (1, 4096, 4096, (64, 1, 1)),
    (8, 102400, 4096, (64, 25, 1)), (128, 102400, 2048, (128, 25, 2)),
    (200, 102400, 4096, (256, 25, 1)), (1, 1024, 1024, (64, 1, 1)),
    (65, 13312, 2048, (128, 4, 2)), (1, 16384, 4096, (64, 4, 1))])
def test_bucketed_sweep_grid(bq, n, nbuckets, plan):
    """(Bqp, rounds_per_group, groups) of K5's int8/bf16 sweep on 132 SMs:
    blocks of 32 bucket positions x 64 or 128 queries, as many round groups
    as fill the SMs once (4,096 buckets: 128 blocks already)."""
    assert topk.bucketed_sweep_grid(bq, n, nbuckets, sms=132) == plan


# ---------------------------------------- K5 / K6 decompositions, in torch

_NONE = 0  # the kernels' empty key: below every live key


def _score_key(score: float, low: int) -> int:
    """A 64-bit unsigned key as the kernels build it: the order-preserving
    bits of an f32 score (-0 as +0) above a 32-bit ``low`` word."""
    u = int(np.float32(0.0 if score == 0 else score).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return (u << 32) | low


def _key_score(key: int) -> np.float32:
    u = key >> 32
    u = (u & 0x7FFFFFFF) if u & 0x80000000 else (~u & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def _block_topk(thread_keys, k):
    """flat::block_topk: tau = the k-th largest live thread maximum (1 with
    fewer than k), keep the live keys >= tau, rank each by the kept keys
    above it; the k largest in descending order."""
    maxima = sorted((max(ks) for ks in thread_keys if ks and max(ks)), reverse=True)
    tau = maxima[k - 1] if len(maxima) >= k else 1
    kept = [x for ks in thread_keys for x in ks if x and x >= tau]
    assert len(kept) >= min(k, sum(1 for ks in thread_keys for x in ks if x))
    return sorted(kept, reverse=True)[:k]


def _weighted_scores(queries, corpus, valid):
    q, qscale = topk.quantize_queries(queries, corpus.dtype)
    return topk._weighted_mask(topk._tile_scores(q, corpus), valid.float()[None, :]), qscale


def _bucketed_sweep_keys(s, nbuckets, rounds_per_group, cols):
    """The sweep of K5 and K7 over weighted scores ``s`` [Bq, N], in plain
    torch: blocks of ``cols`` bucket positions x a group of
    ``rounds_per_group`` consecutive rounds, each keeping its buckets' best
    weighted score and round (strict >, rounds in order, from NEG) and
    writing the key (score, inverted column), 0 if nothing live reached the
    bucket. Returns keys[group][row][position]."""
    bq, n = s.shape
    rounds = -(-n // nbuckets)
    groups = -(-rounds // rounds_per_group)
    keys = [[[_NONE] * nbuckets for _ in range(bq)] for _ in range(groups)]
    for g in range(groups):
        for b0 in range(0, nbuckets, cols):
            pos = torch.arange(b0, min(b0 + cols, nbuckets))
            best = torch.full((bq, len(pos)), topk.NEG)
            best_r = torch.zeros((bq, len(pos)), dtype=torch.int64)
            for r in range(g * rounds_per_group, min(rounds, (g + 1) * rounds_per_group)):
                c = r * nbuckets + pos
                if c[0] >= n:
                    break
                better = s[:, c] > best
                best = torch.where(better, s[:, c], best)
                best_r = torch.where(better, torch.full_like(best_r, r), best_r)
            for row in range(bq):
                for j, p in enumerate(pos.tolist()):
                    if best[row, j] > topk.NEG:
                        col = int(best_r[row, j]) * nbuckets + p
                        keys[g][row][p] = _score_key(float(best[row, j]), 0xFFFFFFFF - col)
    return keys


def _bucketed_decomposed(queries, corpus, valid, k, nbuckets, rounds_per_group, cols,
                         threads=256):
    """K5's CUDA decomposition, in plain torch: the sweep
    (``_bucketed_sweep_keys``), then the extract: fold the groups' keys by
    max; re-key (score, inverted position, inverted round); ``threads``
    threads holding positions tid + threads*i; flat::block_topk; empties
    (NEG, bucket 0's column or -1)."""
    s, qscale = _weighted_scores(queries, corpus, valid)
    bq = s.shape[0]
    keys = _bucketed_sweep_keys(s, nbuckets, rounds_per_group, cols)
    groups = len(keys)
    out_s = torch.full((bq, k), topk.NEG)
    out_i = torch.full((bq, k), -1, dtype=torch.int32)
    for row in range(bq):
        folded = [max(keys[g][row][p] for g in range(groups)) for p in range(nbuckets)]
        fill = 0xFFFFFFFF - (folded[0] & 0xFFFFFFFF) if folded[0] else -1
        per_thread = [[] for _ in range(threads)]
        for p, key in enumerate(folded):
            if key:
                col = 0xFFFFFFFF - (key & 0xFFFFFFFF)
                key = (key >> 32 << 32) | ((4095 - p) << 20) | ((1 << 20) - 1 - (col - p) // nbuckets)
            per_thread[p % threads].append(key)
        sel = _block_topk(per_thread, k)
        for rank in range(k):
            if rank < len(sel):
                key = sel[rank]
                p = 4095 - ((key >> 20) & 4095)
                out_s[row, rank] = float(_key_score(key))
                out_i[row, rank] = ((1 << 20) - 1 - (key & 0xFFFFF)) * nbuckets + p
            else:
                out_i[row, rank] = fill
    return topk._rescale(out_s, qscale), out_i


def _bucketed_topk_decomposed(queries, corpus, valid, k, nbuckets, rounds_per_group, cols):
    """K7's CUDA decomposition, in plain torch: the sweep
    (``_bucketed_sweep_keys``); the write kernel folding each bucket's keys
    over the groups by max and writing (score, column), or (NEG, -1) where
    the key is 0; then the wrapper's stable top k and the query scale."""
    s, qscale = _weighted_scores(queries, corpus, valid)
    bq = s.shape[0]
    keys = _bucketed_sweep_keys(s, nbuckets, rounds_per_group, cols)
    bucket_s = torch.full((bq, nbuckets), topk.NEG)
    bucket_i = torch.full((bq, nbuckets), -1, dtype=torch.int32)
    for row in range(bq):
        for p in range(nbuckets):
            key = max(group[row][p] for group in keys)
            if key:
                bucket_s[row, p] = float(_key_score(key))
                bucket_i[row, p] = 0xFFFFFFFF - (key & 0xFFFFFFFF)
    top_s, top_i = topk._stable_topk(bucket_s, bucket_i, k)
    return topk._rescale(top_s, qscale), top_i


def _exact_decomposed(queries, corpus, valid, k, tiles_per_group, buf, rows=32, chunk=4096,
                      threads=256, block_n=1024):
    """K6's CUDA decomposition, in plain torch. The sweep: groups of
    ``tiles_per_group`` consecutive ``rows``-row tiles; per query row a list
    of its k best keys, a buffer of ``buf`` keys and a threshold (the list's
    k-th score, NEG while short); a weighted score strictly above it is
    appended; before a tile could overflow the buffer (more than buf - rows
    entries) the row flushes: for k <= 32 and more than 2k candidates the
    k-th largest of the 32 lanes' two largest (lane l holding [list |
    buffer] entries l, l + 32, ..) prunes them, and the rest are ranked.
    After the group's last tile the row's [list | buffer] goes to the merge
    as it is, with its length. The merge: the groups' entries in rank-major
    order (entry j of group g is candidate j * groups + g, up to the longest
    group, an entry past a group's length empty), in chunks of ``chunk``
    keys (those above the running k-th key; a chunk left empty skipped)
    beside the running top k, through flat::block_topk with
    ``threads`` threads; empties (NEG, the best live row below N -
    block_n, or -1)."""
    s, qscale = _weighted_scores(queries, corpus, valid)
    bq, n = s.shape
    ntiles = n // rows
    groups = -(-ntiles // tiles_per_group)
    sn = s.numpy()
    out = [[None] * bq for _ in range(groups)]
    for g in range(groups):
        tiles = range(g * tiles_per_group, min(ntiles, (g + 1) * tiles_per_group))
        for row in range(bq):
            lst, pend, thr = [], [], np.float32(topk.NEG)
            for t in tiles:
                for c in range(t * rows, (t + 1) * rows):
                    if sn[row, c] > thr:
                        pend.append(_score_key(float(sn[row, c]), 0xFFFFFFFF - c))
                assert len(pend) <= buf
                if t != tiles[-1] and len(pend) > buf - rows:
                    cand = lst + pend
                    pivot = 1
                    if k <= 32 and len(cand) > 2 * k:
                        top2 = sorted((v for l in range(min(32, len(cand)))
                                       for v in sorted(cand[l::32], reverse=True)[:2]),
                                      reverse=True)
                        pivot = top2[k - 1]
                    kept = [x for x in cand if x >= pivot]
                    assert len(kept) >= min(k, len(cand))
                    lst, pend = sorted(kept, reverse=True)[:k], []
                    thr = _key_score(lst[k - 1]) if len(lst) == k else np.float32(topk.NEG)
            out[g][row] = lst + pend
    out_s = torch.full((bq, k), topk.NEG)
    out_i = torch.full((bq, k), -1, dtype=torch.int32)
    for row in range(bq):
        most = max(len(out[g][row]) for g in range(groups))
        cands = [out[p % groups][row][p // groups] if p // groups < len(out[p % groups][row])
                 else _NONE for p in range(groups * most)]
        run = []
        for base in range(0, len(cands), chunk):
            floor = run[k - 1] if len(run) == k else _NONE   # keys at or below cannot enter
            part = [x if x > floor else _NONE for x in cands[base:base + chunk]]
            if not any(part):
                continue
            per_thread = [part[t::threads] + (run[t:t + 1] if t < len(run) else [])
                          for t in range(threads)]
            run = _block_topk(per_thread, k)
        idx = [0xFFFFFFFF - (key & 0xFFFFFFFF) for key in run]
        fill = next((i for i in idx if i < n - block_n), -1)
        for rank in range(k):
            if rank < len(run):
                out_s[row, rank] = float(_key_score(run[rank]))
                out_i[row, rank] = idx[rank]
            else:
                out_i[row, rank] = fill
    return topk._rescale(out_s, qscale), out_i


def _decomposition_case(name):
    """(q, x, valid, dtype) on numpy: exact-grid f32 with repeated rows and
    dead slots; fewer live rows than k (one in the last tile, one at column
    0); one tile; int8 rows with per-row weights on the grid; and the int8
    index's own quantization of real unit vectors (int32 dots: exact)."""
    rng = np.random.default_rng(21)
    n = 1024 if name == "one_tile" else 4096
    q, x = _grid(rng, (6, 64)), _grid(rng, (n, 64))
    valid = np.ones(n, np.float32)
    dtype = "float32"
    if name == "exact_grid_ties":
        x[1024:2048] = x[:1024]
        x[2048 + 5] = x[5]
        x[70] = x[5]
        valid[rng.choice(n, 600, replace=False)] = 0.0
    if name == "few_live":
        valid[:] = 0.0
        valid[[0, 1500, 2100, 3500]] = 1.0
    if name == "int8_grid_weights":
        dtype = "int8"
        valid = rng.choice([0.0, 0.01, 0.02], n).astype(np.float32)
    if name == "int8_unit_vectors":
        dtype = "int8"
        q = rng.standard_normal((6, 64)).astype(np.float32)
        v = rng.standard_normal((n, 64)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        m = np.abs(v).max(axis=1)
        x = np.clip(np.round(v * (127.0 / m[:, None])), -127, 127) / 16.0
        valid = (m / 127.0) / np.float32(0.01)
        valid[::9] = 0.0
    return q, x, valid, dtype


DECOMPOSITION_CASES = ["exact_grid_ties", "few_live", "one_tile", "int8_grid_weights",
                       "int8_unit_vectors"]


@pytest.mark.parametrize("split", [(1, 32, 256), (2, 32, 256), (3, 64, 64), (4, 1024, 256)],
                         ids=["1round-32cols", "2rounds-32cols", "3rounds-64cols-64threads",
                              "allrounds-1024cols"])
@pytest.mark.parametrize("case", DECOMPOSITION_CASES)
def test_bucketed_fused_decomposition_matches_plain_and_pallas(case, split):
    """Any split of K5's rounds into consecutive groups and of its buckets
    into column slices, the groups' keys folded by max and the extract's
    threshold-and-rank selection by (score, lower bucket position), give the
    plain version's result bit for bit, bucket 0's fill included, and the
    Pallas kernel's ids and scores (exact-grid and int8 data: every score is
    exact; int8 scores within 1e-6 after the query scale, the unit-vector
    test's bar)."""
    q, x, valid, dtype = _decomposition_case(case)
    k, nbuckets = 24, 1024
    jx, tx, v = _corpus(x, valid, dtype)
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    got_s, got_i = _bucketed_decomposed(tq, tx, tv, k, nbuckets, *split)
    want_s, want_i = topk.bucketed_topk_fused_plain(tq, tx, tv, k, nbuckets=nbuckets)
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
    ref_s, ref_i = jax_topk.bucketed_topk_fused(jnp.asarray(q), jx, jnp.asarray(v), k,
                                                interpret=True, nbuckets=nbuckets)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0,
                               atol=1e-6 if dtype == "int8" else 0.0)
    if case == "few_live":   # bucket 0 holds column 0: the empties carry it
        assert (got_i[:, 4:] == 0).all() and (got_s[:, 4:] == topk.NEG).all()


@pytest.mark.parametrize("split", [(1, 32), (2, 32), (3, 64), (4, 1024)],
                         ids=["1round-32cols", "2rounds-32cols", "3rounds-64cols",
                              "allrounds-1024cols"])
@pytest.mark.parametrize("case", DECOMPOSITION_CASES)
def test_bucketed_topk_decomposition_matches_plain_and_pallas(case, split):
    """Any split of K7's rounds into consecutive groups and of its buckets
    into column slices, the groups' keys folded by max and written as
    (score, column) or (NEG, -1), then the stable top k, give the plain
    version's result bit for bit and the Pallas kernel's (exact-grid and
    int8 data; int8 scores within 1e-6 after the query scale, the
    unit-vector test's bar), the empty slots (NEG, -1) included."""
    q, x, valid, dtype = _decomposition_case(case)
    k, nbuckets = 24, 1024
    jx, tx, v = _corpus(x, valid, dtype)
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    got_s, got_i = _bucketed_topk_decomposed(tq, tx, tv, k, nbuckets, *split)
    want_s, want_i = topk.bucketed_topk_plain(tq, tx, tv, k, nbuckets=nbuckets)
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
    ref_s, ref_i = jax_topk.bucketed_topk(jnp.asarray(q), jx, jnp.asarray(v), k,
                                          interpret=True, nbuckets=nbuckets)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0,
                               atol=1e-6 if dtype == "int8" else 0.0)
    if case == "few_live":   # four live rows: the other slots are empty
        assert (got_i[:, 4:] == -1).all() and (got_s[:, 4:] == topk.NEG).all()


@pytest.mark.parametrize("split", [(1, 192, 32, 4096), (3, 32, 32, 64), (7, 40, 8, 100),
                                   (128, 192, 32, 4096)],
                         ids=["1tile-buf192", "3tiles-buf32-chunk64", "7tiles-rows8-buf40-chunk100",
                              "alltiles-buf192"])
@pytest.mark.parametrize("case", DECOMPOSITION_CASES)
def test_exact_decomposition_matches_plain_and_pallas(case, split):
    """Any split of K6's tiles into consecutive groups, the per-row
    threshold filter with buffers small enough to flush after nearly every
    tile (buf - rows = 0 or 32), the pivot's pruning, the groups' lists and
    buffers left unflushed at the end, and the merge in chunks of as few as
    64 keys beside the running top k, give the plain
    version's result bit for bit, the last-tile fill included, and the
    Pallas kernel's ids and scores (within 1e-6 for int8 after the query
    scale)."""
    q, x, valid, dtype = _decomposition_case(case)
    k = 24
    tiles_per_group, buf, rows, chunk = split
    jx, tx, v = _corpus(x, valid, dtype)
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    got_s, got_i = _exact_decomposed(tq, tx, tv, k, tiles_per_group, buf, rows, chunk)
    want_s, want_i = topk.topk_matmul_plain(tq, tx, tv, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
    ref_s, ref_i = jax_topk.topk_matmul(jnp.asarray(q), jx, jnp.asarray(v), k, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0,
                               atol=1e-6 if dtype == "int8" else 0.0)
    if case == "few_live":   # the best live row outside the last 1,024-row tile
        assert (got_s[:, 4:] == topk.NEG).all()
        assert set(got_i[:, 4:].ravel().tolist()) <= {0, 1500, 2100}


def test_exact_decomposition_at_k_128_and_k_1():
    """k above 32 skips the pivot's pruning; k = 1 prunes to one key."""
    q, x, valid, dtype = _decomposition_case("exact_grid_ties")
    jx, tx, v = _corpus(x, valid, dtype)
    tq, tv = torch.from_numpy(q[:2]), torch.from_numpy(v)
    for k in (1, 128):
        got = _exact_decomposed(tq, tx, tv, k, 5, 224 - (-(-k // 32) * 32))
        want = topk.topk_matmul_plain(tq, tx, tv, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), k


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
