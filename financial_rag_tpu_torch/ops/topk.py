"""Flat-index top-k: the four sweeps of financial_rag_tpu/ops/topk.py.

Each wrapper launches its CUDA kernel for CUDA tensors, counts the launch
in ``LAUNCHES[<wrapper name>]``, and runs its plain version (same module,
``*_plain``) for CPU tensors; each keeps the JAX function's result contract
bit for bit, ties and empty slots included:

- ``packed_topk_fused`` (K4, ``csrc/packed_topk.cu``): packed score + tile
  id, per-bucket top-2, exact final top-k with ties to the earlier position.
  The float-corpus serving sweep.
- ``bucketed_topk_fused`` (K5) and ``bucketed_topk`` (K7), one source
  (``csrc/bucketed_topk.cu``): the running max of each bucket (column mod
  nbuckets), then the top-k of the bucket maxima, fused (K5, the int8
  index's sweep) or by a stable sort outside the kernel (K7, backend
  ``pallas_bucketed``).
- ``topk_matmul`` (K6, ``csrc/topk_exact.cu``): the exact top-k, ties to the
  lower corpus index (backend ``pallas_exact``).

``topk_matmul_reference`` is the exact sweep that the JAX package runs off
the TPU (backend ``xla``), written as plain PyTorch. The per-query int8
scale (``quantize_queries``) is applied outside the kernels, as in JAX.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import round_up

NEG = -3.0e4  # below any cosine similarity; safe in bf16/f32

INT8_SCALE = 127.0  # int8 level count; actual scales are per-vector/per-query max-abs

LAUNCHES: Counter = Counter()   # kernel launches, by wrapper name
KERNEL_QUERY_TILE = 64  # queries are padded to a multiple for the CUDA sweeps
KERNEL_COLUMNS = 16     # bucket columns per block of the bucketed CUDA sweeps
EXACT_CHUNK = 128       # corpus columns the exact CUDA sweep scores per step
EXACT_MAX_K = 128       # list length of the exact CUDA sweep
EXACT_MERGE_CANDIDATES = 4096  # groups * k the exact sweep's merge holds


def _tile_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Raw f32 similarity of a query block against a corpus block. bf16
    products are exact in f32; for int8 every partial sum is an integer of
    magnitude <= 127*127*D < 2**24 (D <= 1040), so the f32 product equals
    the int32 dot the TPU takes."""
    return q.float() @ x.float().T


def _weighted_mask(scores: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """scores * per-row weight, with empty slots (w == 0) pushed below any
    real score. Float corpora carry weight 1.0 for live slots; int8 corpora
    carry max|v|/127, which dequantizes the integer dot."""
    live = (w > 0.0).float()
    return scores * w + (live - 1.0) * 1.0e5


def quantize_queries(queries: torch.Tensor, corpus_dtype):
    """Match query dtype to the corpus. Returns (queries, qscale): qscale is
    a per-query [Bq, 1] f32 factor restoring score calibration for int8
    corpora (None for float corpora)."""
    if corpus_dtype == torch.int8:
        m = queries.float().abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
        q = torch.round(queries.float() * (INT8_SCALE / m)).clamp(-127, 127).to(torch.int8)
        return q, (m / INT8_SCALE).float()
    return queries.to(corpus_dtype), None


def stable_topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the top k along dim 1, ties to the earlier position
    (lax.top_k's order; torch.topk promises none for ties on CUDA)."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def _stable_topk(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """(scores, idx) of the top k along dim 1, ties to the earlier position."""
    order = stable_topk_indices(scores, k)
    return scores.gather(1, order), idx.gather(1, order)


def _rescale(scores: torch.Tensor, qscale: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-query int8 scale on live scores; sentinels (<= NEG) stay NEG."""
    if qscale is None:
        return scores
    return torch.where(scores > NEG, scores * qscale, torch.full_like(scores, NEG))


def topk_matmul_reference(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                          k: int, *, chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over corpus chunks with a running merge; ties go to the
    lower corpus index. Returns (scores [Bq, k] f32, idx [Bq, k] int32)."""
    bq = queries.shape[0]
    n = corpus.shape[0]
    chunk = min(chunk, n)
    assert n % chunk == 0, f"corpus rows {n} must be a multiple of chunk {chunk}"
    q, qscale = quantize_queries(queries, corpus.dtype)
    dev = corpus.device
    run_s = torch.full((bq, k), NEG, dtype=torch.float32, device=dev)
    run_i = torch.full((bq, k), -1, dtype=torch.int32, device=dev)
    valid = valid.float()
    for c0 in range(0, n, chunk):
        s = _weighted_mask(_tile_scores(q, corpus[c0:c0 + chunk]), valid[None, c0:c0 + chunk])
        idx = torch.arange(c0, c0 + chunk, dtype=torch.int32, device=dev).expand(bq, chunk)
        # running top-k first: on ties the earlier (lower-index) entry wins
        run_s, run_i = _stable_topk(torch.cat([run_s, s], dim=1),
                                    torch.cat([run_i, idx], dim=1), k)
    if qscale is not None:
        run_s = torch.where(run_s > NEG, run_s * qscale, torch.full_like(run_s, NEG))
    return run_s, run_i


def _packing(n: int, block_n: int):
    block_n = min(block_n, n)
    assert n % block_n == 0, f"corpus rows {n} must be a multiple of block_n {block_n}"
    ntiles = n // block_n
    bits = max(int(np.ceil(np.log2(ntiles))), 1) if ntiles > 1 else 1
    return block_n, ntiles, bits


def tile_groups(ntiles: int, base_blocks: int, sms: int) -> int:
    """Consecutive corpus tiles per block of the CUDA sweep: few enough that
    the sweep has about eight blocks per SM in flight (a query tile has only
    block_n / 16 column blocks). Returns tiles_per_group."""
    groups = min(ntiles, max(1, -(-8 * sms // base_blocks)))
    return -(-ntiles // groups)


def packed_topk_fused_plain(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                            k: int, *, block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed sweep's contract, bit for bit through int32 views:
    per-bucket running top-2 of packed (score + 2, tile id) words, then an
    exact top-k over [best | runner-up] with ties to the earlier position."""
    assert corpus.dtype != torch.int8, "int8 corpora need bucketed_topk_fused"
    bq = queries.shape[0]
    n = corpus.shape[0]
    block_n, ntiles, bits = _packing(n, block_n)
    mask = (1 << bits) - 1
    maxj = ntiles - 1
    dev = corpus.device

    live = valid.reshape(1, n) > 0.0
    s = _tile_scores(queries.to(corpus.dtype), corpus)                    # [Bq, N]
    p = s * live.float() + torch.where(live, 2.0, -2.0).float()
    tile = torch.arange(n, device=dev, dtype=torch.int32) // block_n
    pb = (p.view(torch.int32) & ~mask) | (maxj - tile)[None, :]
    pb = pb.reshape(bq, ntiles, block_n)
    # running top-2 from a (0, 0) init == the two largest of {0, 0} + column
    init = torch.zeros((bq, 2, block_n), dtype=torch.int32, device=dev)
    top2 = torch.sort(torch.cat([init, pb], dim=1), dim=1, descending=True).values[:, :2]
    packed = top2.reshape(bq, 2 * block_n)                                # [b1 | b2]

    t = torch.arange(2 * block_n, device=dev, dtype=torch.int32) % block_n
    gidx = (maxj - (packed & mask)) * block_n + t[None, :]
    cand_live = packed > 0
    ps = torch.where(cand_live, packed.view(torch.float32), torch.full_like(s[:, :1], NEG))
    cand_i = torch.where(cand_live, gidx, torch.full_like(gidx, -1))
    if ps.shape[1] < k:  # fewer candidates than k: pad with empties
        pad = k - ps.shape[1]
        ps = torch.cat([ps, ps.new_full((bq, pad), NEG)], dim=1)
        cand_i = torch.cat([cand_i, cand_i.new_full((bq, pad), -1)], dim=1)
    top_p, top_i = _stable_topk(ps, cand_i, k)
    sc = (top_p.view(torch.int32) & ~mask).view(torch.float32) - 2.0
    empty = top_p <= NEG
    return (torch.where(empty, torch.full_like(sc, NEG), sc),
            torch.where(empty, torch.full_like(top_i, -1), top_i))


def packed_topk_fused(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                      k: int, *, block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving sweep over a bf16/f32 corpus. Returns (scores [Bq, k]
    f32, slots [Bq, k] int32); -1 / NEG mark empty results."""
    if corpus.device.type == "cpu":
        return packed_topk_fused_plain(queries, corpus, valid, k, block_n=block_n)
    kernel_lib.require_no_grad("packed_topk_fused", queries, corpus, valid)
    if corpus.dtype == torch.int8:
        raise TypeError("packed_topk_fused is the float-corpus sweep; int8 corpora "
                        "take bucketed_topk_fused")
    bq, d = queries.shape
    n = corpus.shape[0]
    block_n, ntiles, bits = _packing(n, block_n)
    if corpus.shape[1] != d or valid.shape != (n,):
        raise ValueError("queries [Bq,D], corpus [N,D] and valid [N] must agree")
    code = kernel_lib.dtype_code("packed_topk_fused", corpus.dtype)
    vf = valid.to(torch.float32).contiguous()
    dev = kernel_lib.require_cuda(queries, corpus, vf)
    kernel_lib.require_contiguous("packed_topk_fused", corpus)
    bqp = round_up(max(bq, 1), KERNEL_QUERY_TILE)
    q = torch.zeros((bqp, d), dtype=corpus.dtype, device=dev)
    q[:bq] = queries
    per_group = tile_groups(ntiles, (block_n // KERNEL_COLUMNS) * (bqp // KERNEL_QUERY_TILE),
                            torch.cuda.get_device_properties(dev).multi_processor_count)
    groups = -(-ntiles // per_group)
    b1 = torch.empty((groups, bqp, block_n), dtype=torch.int32, device=dev)
    b2 = torch.empty_like(b1)
    out_s = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    kernel_lib.launch("packed_topk_fused", "frag_packed_topk", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(corpus), kernel_lib.ptr(vf),
                      kernel_lib.ptr(b1), kernel_lib.ptr(b2), kernel_lib.ptr(out_s),
                      kernel_lib.ptr(out_i), bq, bqp, n, d, block_n, bits, k, per_group,
                      code)
    LAUNCHES["packed_topk_fused"] += 1
    return out_s, out_i


# ------------------------------------------------- K5 / K7: bucketed sweeps


def _nbuckets(n: int, nbuckets: int, block_n: int) -> int:
    """The JAX wrappers' bucket count: N when N < nbuckets, a multiple of
    block_n either way."""
    if n % block_n:
        raise ValueError(f"corpus rows {n} must be a multiple of block_n {block_n}")
    nbuckets = min(nbuckets, n)
    if nbuckets % block_n:
        raise ValueError(f"nbuckets {nbuckets} must be a multiple of block_n {block_n}")
    return nbuckets


def _bucket_maxima(q: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor, nbuckets: int):
    """[Bq, nbuckets] running max of each bucket over the corpus in order:
    column c updates bucket c mod nbuckets when its weighted score is
    strictly greater (the earlier column keeps a tie); (NEG, -1) where no
    live column reached the bucket."""
    bq, n = q.shape[0], corpus.shape[0]
    dev = corpus.device
    best_s = torch.full((bq, nbuckets), NEG, dtype=torch.float32, device=dev)
    best_i = torch.full((bq, nbuckets), -1, dtype=torch.int32, device=dev)
    w = valid.float()
    for c0 in range(0, n, nbuckets):
        m = min(nbuckets, n - c0)
        s = _weighted_mask(_tile_scores(q, corpus[c0:c0 + m]), w[None, c0:c0 + m])
        better = s > best_s[:, :m]
        best_s[:, :m] = torch.where(better, s, best_s[:, :m])
        col = torch.arange(c0, c0 + m, dtype=torch.int32, device=dev).expand(bq, m)
        best_i[:, :m] = torch.where(better, col, best_i[:, :m])
    return best_s, best_i


def bucketed_topk_fused_plain(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                              k: int, *, nbuckets: int = 4096,
                              block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bucket maxima, then _merge_topk's k-step extraction: largest
    first, ties to the lower bucket position. An extracted bucket drops to
    NEG with its index kept, so once the live buckets are spent every
    further step takes position 0 again: empty results are (NEG, index of
    bucket 0)."""
    nbuckets = _nbuckets(corpus.shape[0], nbuckets, block_n)
    if not 1 <= k <= nbuckets:
        raise ValueError(f"k={k} must lie in [1, nbuckets={nbuckets}]")
    q, qscale = quantize_queries(queries, corpus.dtype)
    bs, bi = _bucket_maxima(q, corpus, valid, nbuckets)
    top_s, top_i = _stable_topk(bs, bi, k)
    top_i = torch.where(top_s > NEG, top_i, bi[:, :1].expand_as(top_i))
    return _rescale(top_s, qscale), top_i


def bucketed_topk_plain(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                        k: int, *, nbuckets: int = 4096,
                        block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bucket maxima, then lax.top_k's order (stable: ties to the lower
    bucket position); empty results are (NEG, -1)."""
    nbuckets = _nbuckets(corpus.shape[0], nbuckets, block_n)
    if not 1 <= k <= nbuckets:
        raise ValueError(f"k={k} must lie in [1, nbuckets={nbuckets}]")
    q, qscale = quantize_queries(queries, corpus.dtype)
    top_s, top_i = _stable_topk(*_bucket_maxima(q, corpus, valid, nbuckets), k)
    return _rescale(top_s, qscale), top_i


def _kernel_inputs(name: str, queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor):
    """Queries quantized / cast as the corpus and padded to the query tile,
    weights as f32; checks device, dtype and shapes."""
    kernel_lib.require_no_grad(name, queries, corpus, valid)
    bq, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d or valid.shape != (n,):
        raise ValueError(f"{name}: queries [Bq,D], corpus [N,D] and valid [N] must agree")
    code = kernel_lib.dtype_code(name, corpus.dtype,
                                 allowed=(torch.float32, torch.bfloat16, torch.int8))
    vf = valid.to(torch.float32).contiguous()
    dev = kernel_lib.require_cuda(queries, corpus, vf)
    kernel_lib.require_contiguous(name, corpus)
    if d % (32 if corpus.dtype == torch.int8 else 16):
        raise ValueError(f"{name}: D={d} must be a multiple of 16 (32 for int8)")
    qq, qscale = quantize_queries(queries, corpus.dtype)
    bqp = round_up(max(bq, 1), KERNEL_QUERY_TILE)
    q = torch.zeros((bqp, d), dtype=corpus.dtype, device=dev)
    q[:bq] = qq
    return q, qscale, vf, dev, code


def _bucketed_launch(name: str, queries, corpus, valid, k: int, nbuckets: int, block_n: int):
    """K5 (k > 0: [Bq, k] out) or K7 (k == 0: the [Bq, nbuckets] maxima)."""
    n = corpus.shape[0]
    nbuckets = _nbuckets(n, nbuckets, block_n)
    q, qscale, vf, dev, code = _kernel_inputs(name, queries, corpus, valid)
    bq, bqp = queries.shape[0], q.shape[0]
    rounds = -(-n // nbuckets)
    per_group = tile_groups(rounds, (nbuckets // KERNEL_COLUMNS) * (bqp // KERNEL_QUERY_TILE),
                            torch.cuda.get_device_properties(dev).multi_processor_count)
    groups = -(-rounds // per_group)
    keys = torch.empty((groups, bqp, nbuckets), dtype=torch.int64, device=dev)
    width = k if k > 0 else nbuckets
    out_s = torch.empty((bq, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, width), dtype=torch.int32, device=dev)
    kernel_lib.launch(name, "frag_bucketed_topk", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(corpus), kernel_lib.ptr(vf),
                      kernel_lib.ptr(keys), kernel_lib.ptr(out_s), kernel_lib.ptr(out_i),
                      bq, bqp, n, q.shape[1], nbuckets, k, per_group, code)
    LAUNCHES[name] += 1
    return out_s, out_i, qscale


def bucketed_topk_fused(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                        k: int, *, nbuckets: int = 4096,
                        block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 index's sweep (any corpus dtype): bucket maxima with the
    final k-extraction fused. Returns (scores [Bq, k] f32, slots [Bq, k]
    int32)."""
    if corpus.device.type == "cpu":
        return bucketed_topk_fused_plain(queries, corpus, valid, k, nbuckets=nbuckets,
                                         block_n=block_n)
    if not 1 <= k <= min(256, nbuckets, corpus.shape[0]):
        raise ValueError(f"bucketed_topk_fused: k={k} outside the kernel's [1, 256] "
                         "or above nbuckets")
    out_s, out_i, qscale = _bucketed_launch("bucketed_topk_fused", queries, corpus, valid, k,
                                            nbuckets, block_n)
    return _rescale(out_s, qscale), out_i


def bucketed_topk(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                  k: int, *, nbuckets: int = 4096,
                  block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Near-exact top-k (backend ``pallas_bucketed``): the kernel writes the
    [Bq, nbuckets] maxima, a stable sort takes the top k. Exact when
    N <= nbuckets."""
    if corpus.device.type == "cpu":
        return bucketed_topk_plain(queries, corpus, valid, k, nbuckets=nbuckets,
                                   block_n=block_n)
    if not 1 <= k <= min(nbuckets, corpus.shape[0]):
        raise ValueError(f"bucketed_topk: k={k} must lie in [1, nbuckets]")
    bucket_s, bucket_i, qscale = _bucketed_launch("bucketed_topk", queries, corpus, valid, 0,
                                                  nbuckets, block_n)
    top_s, top_i = _stable_topk(bucket_s, bucket_i, k)
    return _rescale(top_s, qscale), top_i


# ------------------------------------------------------- K6: exact sweep


def topk_matmul_plain(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                      k: int, *, block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of the live weighted scores (> NEG), ties to the
    lower corpus index. Slots no live row reached hold NEG and, as the TPU
    kernel's running extraction leaves them, the best live row outside the
    last block_n tile (-1 if none)."""
    n = corpus.shape[0]
    if n % block_n:
        raise ValueError(f"corpus rows {n} must be a multiple of block_n {block_n}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, N={n}]")
    q, qscale = quantize_queries(queries, corpus.dtype)
    s = _weighted_mask(_tile_scores(q, corpus), valid.float()[None, :])
    s = torch.where(s > NEG, s, torch.full_like(s, NEG))
    idx = torch.arange(n, dtype=torch.int32, device=corpus.device).expand_as(s)
    top_s, top_i = _stable_topk(s, idx, k)
    live = top_s > NEG
    early = live & (top_i < n - block_n)
    fill = torch.where(early.any(dim=1),
                       top_i.gather(1, early.int().argmax(dim=1, keepdim=True)).squeeze(1),
                       torch.full_like(top_i[:, 0], -1))
    top_i = torch.where(live, top_i, fill[:, None].expand_as(top_i))
    return _rescale(top_s, qscale), top_i


def exact_groups(nchunks: int, qtiles: int, k: int, sms: int) -> int:
    """Consecutive EXACT_CHUNK-column chunks per block of the exact CUDA
    sweep: tile_groups' split, but at most EXACT_MERGE_CANDIDATES groups x k
    list entries for the merge. Returns chunks_per_group."""
    max_groups = max(1, EXACT_MERGE_CANDIDATES // k)
    return max(tile_groups(nchunks, qtiles, sms), -(-nchunks // max_groups))


def topk_matmul(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                k: int, *, block_n: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (backend ``pallas_exact``). Returns (scores [Bq, k] f32,
    slots [Bq, k] int32)."""
    if corpus.device.type == "cpu":
        return topk_matmul_plain(queries, corpus, valid, k, block_n=block_n)
    n = corpus.shape[0]
    if n % block_n or block_n % EXACT_CHUNK:
        raise ValueError(f"topk_matmul: corpus rows {n} must be a multiple of block_n "
                         f"{block_n}, itself a multiple of {EXACT_CHUNK}")
    if not 1 <= k <= min(EXACT_MAX_K, n):
        raise ValueError(f"topk_matmul: k={k} outside the kernel's [1, {EXACT_MAX_K}]")
    q, qscale, vf, dev, code = _kernel_inputs("topk_matmul", queries, corpus, valid)
    bq, bqp = queries.shape[0], q.shape[0]
    nchunks = n // EXACT_CHUNK
    per_group = exact_groups(nchunks, bqp // KERNEL_QUERY_TILE, k,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
    groups = -(-nchunks // per_group)
    kcap = round_up(k, 32)
    lists = torch.empty((groups, bqp, kcap), dtype=torch.int64, device=dev)
    out_s = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    kernel_lib.launch("topk_matmul", "frag_topk_exact", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(corpus), kernel_lib.ptr(vf),
                      kernel_lib.ptr(lists), kernel_lib.ptr(out_s), kernel_lib.ptr(out_i),
                      bq, bqp, n, q.shape[1], k, kcap, per_group * EXACT_CHUNK, n - block_n,
                      code)
    LAUNCHES["topk_matmul"] += 1
    return _rescale(out_s, qscale), out_i
