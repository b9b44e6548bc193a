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
  ``pallas_bucketed``). Both take the Hopper sweep over an int8 or bf16
  corpus (``bucketed_sweep_grid``), f32 corpora the older one.
- ``topk_matmul`` (K6, ``csrc/topk_exact.cu``): the exact top-k, ties to the
  lower corpus index (backend ``pallas_exact``); int8 and bf16 corpora take
  the Hopper sweep, f32 the CUDA-core one (``exact_sweep_grid``).

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
from financial_rag_tpu_torch.ops.common import LAUNCH_LOCK, round_up

NEG = -3.0e4  # below any cosine similarity; safe in bf16/f32

INT8_SCALE = 127.0  # int8 level count; actual scales are per-vector/per-query max-abs

LAUNCHES: Counter = Counter()   # kernel launches, by wrapper name
KERNEL_QUERY_TILE = 64  # queries are padded to a multiple for the CUDA sweeps
KERNEL_COLUMNS = 16     # bucket columns per block of K5's and K7's f32 sweep
EXACT_CHUNK = 128       # corpus columns the exact f32 CUDA sweep scores per step
EXACT_MAX_K = 128       # list length of the exact CUDA sweep
SWEEP_ROWS = 32         # corpus rows a tile of the K5-K7 Hopper sweeps (16 where
                        # the queries leave room for fewer than 2 such stages: sweep_rows)
EXACT_ROW_KEYS = {torch.bfloat16: 224, torch.int8: 256}  # a row's list + buffer in K6's Hopper sweep
SWEEP_NARROW_D = 384    # the K5-K7 Hopper sweeps zero-pad the features to this,
SWEEP_WIDE_D = 768      # to this (bge-base, gte-base)
SWEEP_MAX_D = 1024      # or to this (bge-large, gte-large)
EXACT_MAX_D = 384       # K6's Hopper sweep takes the narrow width only
SWEEP_WG_ROW_BYTES = 768  # padded rows this wide or narrower leave two query
                          # warpgroups (128 queries) a block room for a ring
SMEM_BLOCK_LIMIT = 232448  # dynamic shared memory a block may take on the H100 (227 KB)
SWEEP_SMEM_BUDGET = 230400  # what K5's and K6's rings size themselves to (225 KB)
BUCKETED_MAX_BUCKETS = 4096  # K5's extract holds this many bucket maxima
PACKED_ROWS = 64        # queries per warpgroup of the packed sweep (K4); 2 a block from 128
PACKED_COLUMNS = 32     # bucket columns per block of K4's bf16 sweep (16 at D 1,024)
PACKED_MAX_D = 1024     # K4's bf16 sweep zero-pads the features to 384, 768 or this


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


def packed_tile_groups(ntiles: int, base_blocks: int, sms: int) -> int:
    """Consecutive corpus tiles per block of K4's sweep. A block holds a
    whole SM (its queries and a ring of corpus tiles in shared memory), so
    the groups stop where ``base_blocks`` x groups blocks fill the SMs once:
    one more would start a second wave of blocks. Returns tiles_per_group."""
    groups = min(ntiles, max(1, sms // base_blocks))
    return -(-ntiles // groups)


def padded_width(d: int) -> int:
    """The feature width the Hopper sweeps pad a row of D features to."""
    for width in (SWEEP_NARROW_D, SWEEP_WIDE_D):
        if d <= width:
            return width
    return SWEEP_MAX_D


def packed_columns(d: int) -> int:
    """Bucket columns (corpus rows a tile) a block of K4's bf16 sweep
    owns: 32, or 16 at the padded width 1,024, where a warpgroup's 128 KB
    of queries leave room for no two 64 KB stages of 32 rows."""
    return PACKED_COLUMNS // 2 if padded_width(d) == SWEEP_MAX_D else PACKED_COLUMNS


def sweep_rows(row_bytes: int) -> int:
    """Corpus rows a tile of K5's and K7's int8 / bf16 sweep over padded
    rows of ``row_bytes`` (flat_sweep.cuh's Tiles): SWEEP_ROWS, or half of
    it where one warpgroup's queries leave room for fewer than 2 stages of
    SWEEP_ROWS rows (a bf16 row of 1,024 features)."""
    regions = row_bytes // 128
    free = SWEEP_SMEM_BUDGET - 1024 - regions * 8192
    return SWEEP_ROWS if free // (regions * SWEEP_ROWS * 128) >= 2 else SWEEP_ROWS // 2


def query_tile(bqp: int, row_bytes: int) -> int:
    """Queries a block of the Hopper sweeps (K4, K5, K7) takes: 128 (two
    warpgroups) from Bqp = 128 on where a padded row of ``row_bytes`` leaves
    two warpgroups' queries room for a ring of corpus stages, else 64."""
    return 2 * KERNEL_QUERY_TILE if bqp >= 2 * KERNEL_QUERY_TILE and \
        row_bytes <= SWEEP_WG_ROW_BYTES else KERNEL_QUERY_TILE


def packed_sweep_smem(d: int, qtile: int):
    """(stages, dynamic shared-memory bytes) of a block of K4's bf16 sweep,
    as csrc/packed_topk.cu's Sweep sizes it: per 64-query warpgroup its
    queries (d/64 regions of 8 KB at the padded width), and a ring of
    corpus stages (d/64 boxes of ``packed_columns`` rows x 128 bytes): 6 or
    5 stages at 384, 2 at 768 and 3 of 16 rows at 1,024 (where a block
    takes one warpgroup)."""
    pd, wg = padded_width(d), qtile // KERNEL_QUERY_TILE
    stages = {SWEEP_NARROW_D: 6 if wg == 1 else 5, SWEEP_WIDE_D: 2, SWEEP_MAX_D: 3}[pd]
    return stages, wg * (pd // 64) * 8192 + stages * (pd // 64) * packed_columns(d) * 128 + 1024


def bucketed_sweep_smem(row_bytes: int, qtile: int):
    """(stages, dynamic shared-memory bytes) of a block of K5's and K7's
    int8 / bf16 sweep over padded rows of ``row_bytes``, as
    csrc/bucketed_topk.cu's BucketSweep sizes it: the queries, then as many
    corpus stages (``sweep_rows`` rows a stage) as SWEEP_SMEM_BUDGET
    leaves, at most 12."""
    regions, wg = row_bytes // 128, qtile // KERNEL_QUERY_TILE
    stage = regions * sweep_rows(row_bytes) * 128
    stages = min((SWEEP_SMEM_BUDGET - 1024 - wg * regions * 8192) // stage, 12)
    return stages, 1024 + wg * regions * 8192 + stages * stage


def packed_sweep_grid(bq: int, n: int, sms: int, block_n: int = 1024, d: int = 384):
    """K4's launch plan for Bq queries over N corpus rows of D features:
    (Bqp, block_n, bits, tiles_per_group, groups). Queries are tiled by 128
    from Bqp = 128 on at D <= 384, else by 64 (``query_tile``); bucket
    columns by PACKED_COLUMNS; the scratch is [groups, Bqp, block_n]."""
    block_n, ntiles, bits = _packing(n, block_n)
    bqp = round_up(max(bq, 1), PACKED_ROWS)
    qtile = query_tile(bqp, 2 * padded_width(d))
    base = -(-block_n // packed_columns(d)) * -(-bqp // qtile)
    per_group = packed_tile_groups(ntiles, base, sms)
    return bqp, block_n, bits, per_group, -(-ntiles // per_group)


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
    if corpus.shape[1] != d or valid.shape != (n,):
        raise ValueError("queries [Bq,D], corpus [N,D] and valid [N] must agree")
    if not 1 <= k <= 256:
        raise ValueError(f"packed_topk_fused: k={k} outside the kernel's [1, 256]")
    if d % 16 or (corpus.dtype == torch.bfloat16 and d > PACKED_MAX_D):
        raise ValueError(f"packed_topk_fused: D={d} must be a multiple of 16 "
                         f"(and at most {PACKED_MAX_D} for a bf16 corpus)")
    code = kernel_lib.dtype_code("packed_topk_fused", corpus.dtype)
    vf = valid.to(torch.float32).contiguous()
    dev = kernel_lib.require_cuda(queries, corpus, vf)
    kernel_lib.require_contiguous("packed_topk_fused", corpus)
    # the kernel reads only the Bq query rows: no padded copy
    q = queries.to(corpus.dtype).contiguous()
    kernel_lib.require_aligned("packed_topk_fused", q, corpus, vf)
    bqp, block_n, bits, per_group, groups = packed_sweep_grid(
        bq, n, torch.cuda.get_device_properties(dev).multi_processor_count, block_n, d)
    b1 = torch.empty((groups, bqp, block_n), dtype=torch.int32, device=dev)
    b2 = torch.empty_like(b1)
    out_s = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    kernel_lib.launch("packed_topk_fused", "frag_packed_topk", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(corpus), kernel_lib.ptr(vf),
                      kernel_lib.ptr(b1), kernel_lib.ptr(b2), kernel_lib.ptr(out_s),
                      kernel_lib.ptr(out_i), bq, bqp, n, d, block_n, bits, k, per_group,
                      code)
    with LAUNCH_LOCK:
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


def _kernel_inputs(name: str, queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor,
                   *, pad: bool = True):
    """Queries quantized / cast as the corpus (padded with zero rows to the
    query tile where ``pad``: the older sweeps read whole tiles; the Hopper
    sweeps read only the Bq rows), weights as f32; checks device, dtype and
    shapes."""
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
    if not pad:
        q = qq.contiguous()
        kernel_lib.require_aligned(name, q, corpus, vf)
        return q, qscale, vf, dev, code
    bqp = round_up(max(bq, 1), KERNEL_QUERY_TILE)
    q = torch.zeros((bqp, d), dtype=corpus.dtype, device=dev)
    q[:bq] = qq
    return q, qscale, vf, dev, code


def _hopper_sweep(name: str, corpus: torch.Tensor, max_d: int = SWEEP_MAX_D) -> bool:
    """Whether K5-K7 take their Hopper sweep (int8 and bf16 corpora, D <=
    ``max_d``; raises beyond that) rather than the f32 one."""
    if corpus.dtype == torch.float32:
        return False
    if corpus.shape[1] > max_d:
        raise ValueError(f"{name}: D={corpus.shape[1]} above the int8/bf16 sweep's "
                         f"{max_d} features")
    return True


def bucketed_sweep_grid(bq: int, n: int, nbuckets: int, sms: int, row_bytes: int = 768):
    """K5's and K7's launch plan for their int8 / bf16 sweep, Bq queries over N rows in
    nbuckets buckets: (Bqp, rounds_per_group, groups). A block owns
    ``sweep_rows`` bucket positions, 64 queries (128 from Bqp = 128 on where a
    padded row of ``row_bytes`` allows it: ``query_tile``) and a group of
    consecutive rounds, and holds a whole SM, so the groups stop where the
    grid fills the SMs once; the scratch is [groups, Bqp, nbuckets] keys."""
    bqp = round_up(max(bq, 1), KERNEL_QUERY_TILE)
    qtile = query_tile(bqp, row_bytes)
    rounds = -(-n // nbuckets)
    base = -(-nbuckets // sweep_rows(row_bytes)) * -(-bqp // qtile)
    per_group = packed_tile_groups(rounds, base, sms)
    return bqp, per_group, -(-rounds // per_group)


def bucketed_launch_plan(bq: int, n: int, nbuckets: int, sms: int, *, hopper: bool,
                         row_bytes: int = 768):
    """(Bqp, rounds_per_group, groups) of a K5 or K7 launch: the Hopper
    sweep's ``bucketed_sweep_grid`` (int8 and bf16 corpora, padded rows of
    ``row_bytes``), else the f32 sweep's blocks of 64 queries and
    KERNEL_COLUMNS bucket positions with ~8 a SM in flight
    (``tile_groups``)."""
    if hopper:
        return bucketed_sweep_grid(bq, n, nbuckets, sms, row_bytes)
    bqp = round_up(max(bq, 1), KERNEL_QUERY_TILE)
    rounds = -(-n // nbuckets)
    per_group = tile_groups(rounds, (nbuckets // KERNEL_COLUMNS) * (bqp // KERNEL_QUERY_TILE), sms)
    return bqp, per_group, -(-rounds // per_group)


def exact_sweep_grid(bq: int, n: int, sms: int, *, f32: bool = False):
    """K6's launch plan, Bq queries over N rows: (Bqp, rows_per_tile,
    tiles_per_group, groups). The int8 / bf16 sweep takes 64 queries and a
    group of consecutive SWEEP_ROWS-row tiles a block, one block an SM, so
    the groups fill the SMs once; the f32 sweep takes EXACT_CHUNK-column
    steps with ~8 blocks an SM in flight (``tile_groups``). The merge takes
    any number of groups; the scratch is ``exact_scratch_keys``."""
    bqp = round_up(max(bq, 1), KERNEL_QUERY_TILE)
    qtiles = bqp // KERNEL_QUERY_TILE
    rows = EXACT_CHUNK if f32 else SWEEP_ROWS
    tiles = n // rows
    per_group = (tile_groups if f32 else packed_tile_groups)(tiles, qtiles, sms)
    return bqp, rows, per_group, -(-tiles // per_group)


def _bucketed_launch(name: str, queries, corpus, valid, k: int, nbuckets: int, block_n: int):
    """K5 (k > 0: [Bq, k] out) or K7 (k == 0: the [Bq, nbuckets] maxima)."""
    n = corpus.shape[0]
    nbuckets = _nbuckets(n, nbuckets, block_n)
    hopper = _hopper_sweep(name, corpus)
    if hopper and (nbuckets % SWEEP_ROWS or n % SWEEP_ROWS):
        raise ValueError(f"{name}: nbuckets={nbuckets} and N={n} must be multiples of "
                         f"{SWEEP_ROWS} for the int8/bf16 sweep")
    if k > 0 and nbuckets > BUCKETED_MAX_BUCKETS:
        raise ValueError(f"{name}: nbuckets={nbuckets} above the extract's "
                         f"{BUCKETED_MAX_BUCKETS}")
    q, qscale, vf, dev, code = _kernel_inputs(name, queries, corpus, valid, pad=not hopper)
    bq = queries.shape[0]
    bqp, per_group, groups = bucketed_launch_plan(
        bq, n, nbuckets, torch.cuda.get_device_properties(dev).multi_processor_count,
        hopper=hopper, row_bytes=padded_width(corpus.shape[1]) * corpus.element_size())
    keys = torch.empty((groups, bqp, nbuckets), dtype=torch.int64, device=dev)
    width = k if k > 0 else nbuckets
    out_s = torch.empty((bq, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, width), dtype=torch.int32, device=dev)
    kernel_lib.launch(name, "frag_bucketed_topk", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(corpus), kernel_lib.ptr(vf),
                      kernel_lib.ptr(keys), kernel_lib.ptr(out_s), kernel_lib.ptr(out_i),
                      bq, bqp, n, q.shape[1], nbuckets, k, per_group, code)
    with LAUNCH_LOCK:
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


def exact_scratch_keys(dtype, groups: int, bqp: int, kcap: int) -> int:
    """int64 elements of K6's scratch: the f32 sweep's [groups, Bqp, kcap]
    lists; the int8 / bf16 sweep's [groups, Bqp, EXACT_ROW_KEYS] lists and
    buffers, followed by their [groups, Bqp] int32 lengths."""
    if dtype == torch.float32:
        return groups * bqp * kcap
    return groups * bqp * EXACT_ROW_KEYS[dtype] + -(-groups * bqp // 2)


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
    hopper = _hopper_sweep("topk_matmul", corpus, EXACT_MAX_D)
    q, qscale, vf, dev, code = _kernel_inputs("topk_matmul", queries, corpus, valid,
                                              pad=not hopper)
    bq = queries.shape[0]
    bqp, rows, per_group, groups = exact_sweep_grid(
        bq, n, torch.cuda.get_device_properties(dev).multi_processor_count, f32=not hopper)
    kcap = round_up(k, 32)
    lists = torch.empty(exact_scratch_keys(corpus.dtype, groups, bqp, kcap), dtype=torch.int64,
                        device=dev)
    out_s = torch.empty((bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((bq, k), dtype=torch.int32, device=dev)
    kernel_lib.launch("topk_matmul", "frag_topk_exact", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(corpus), kernel_lib.ptr(vf),
                      kernel_lib.ptr(lists), kernel_lib.ptr(out_s), kernel_lib.ptr(out_i),
                      bq, bqp, n, q.shape[1], k, kcap, per_group * rows, n - block_n, code)
    with LAUNCH_LOCK:
        LAUNCHES["topk_matmul"] += 1
    return _rescale(out_s, qscale), out_i
