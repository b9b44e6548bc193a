"""Flat-index top-k: the packed serving sweep (K4) and the exact reference.

``packed_topk_fused`` launches ``csrc/packed_topk.cu`` for CUDA tensors and
runs :func:`packed_topk_fused_plain` for CPU tensors; both keep the result
contract of financial_rag_tpu/ops/topk.py:packed_topk_fused (packed score +
tile id, per-bucket top-2, exact final top-k with ties to the earlier
position). ``topk_matmul_reference`` is the exact sweep that the JAX package
runs off the TPU, written as plain PyTorch. The int8 sweep
(``bucketed_topk_fused``) and the exact / unfused Pallas sweeps
(``topk_matmul``, ``bucketed_topk``) are later slices of the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import round_up

NEG = -3.0e4  # below any cosine similarity; safe in bf16/f32

INT8_SCALE = 127.0  # int8 level count; actual scales are per-vector/per-query max-abs

LAUNCHES = 0
KERNEL_QUERY_TILE = 64  # queries are padded to a multiple for the CUDA sweep
KERNEL_COLUMNS = 16     # bucket columns per block of the CUDA sweep


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


def _stable_topk(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k along dim 1 with ties to the earlier position."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    return scores.gather(1, order), idx.gather(1, order)


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
    global LAUNCHES
    if corpus.dtype == torch.int8:
        raise NotImplementedError("int8 corpora need bucketed_topk_fused, a later "
                                  "slice of the port")
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
    LAUNCHES += 1
    return out_s, out_i
