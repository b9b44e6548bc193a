"""The IVF probe: masked similarity of each query against its probed lists.

Counterpart of financial_rag_tpu/ops/ivf_probe.py. ``probe_scores``
launches ``csrc/ivf_probe.cu`` (K8) for CUDA tensors and runs
:func:`probe_scores_plain` for CPU tensors. The TPU kernel splits large
probe counts for a VMEM limit; the CUDA kernel writes each (query, probe)
row on its own and needs no split.
"""

from __future__ import annotations

import torch

from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops.common import LAUNCH_LOCK
from financial_rag_tpu_torch.ops.topk import _weighted_mask

LAUNCHES = 0


def probe_scores_plain(queries: torch.Tensor, storage: torch.Tensor, weights: torch.Tensor,
                       probes: torch.Tensor) -> torch.Tensor:
    """Counterpart of probe_scores_reference: for each probe column, gather
    the [B, L, D] lists and take the batched dot (int8: exact integer sums
    in f32, as ops/topk._tile_scores argues), then raw dot x weight, -1e5
    where the weight is 0. Returns [B, P, L] f32."""
    probes = probes.long()
    w = weights.float()
    q = queries.float()
    cols = []
    for p in range(probes.shape[1]):
        tile = storage[probes[:, p]].float()                     # [B, L, D]
        s = torch.einsum("bd,bld->bl", q, tile)
        cols.append(_weighted_mask(s, w[probes[:, p]]))
    return torch.stack(cols, dim=1)


def probe_scores(queries: torch.Tensor, storage: torch.Tensor, weights: torch.Tensor,
                 probes: torch.Tensor) -> torch.Tensor:
    """queries [B, D] (dtype matched to storage by the caller), storage
    [nlist, L, D] f32/bf16/int8, weights [nlist, L] f32 (0 = empty slot,
    else the dequantization weight), probes [B, P] list ids. Returns scores
    [B, P, L] f32: raw dot x weight for live slots, -1e5 for empty ones. The
    caller applies the per-query int8 scale."""
    if storage.device.type == "cpu":
        return probe_scores_plain(queries, storage, weights, probes)
    global LAUNCHES
    kernel_lib.require_no_grad("probe_scores", queries, storage, weights)
    b, d = queries.shape
    nlist, list_size, sd = storage.shape
    if sd != d or weights.shape != (nlist, list_size) or probes.ndim != 2 or probes.shape[0] != b:
        raise ValueError("probe_scores: queries [B,D], storage [nlist,L,D], weights "
                         "[nlist,L] and probes [B,P] must agree")
    if queries.dtype != storage.dtype:
        raise TypeError(f"probe_scores: queries are {queries.dtype}, storage {storage.dtype}")
    code = kernel_lib.dtype_code("probe_scores", storage.dtype,
                                 allowed=(torch.float32, torch.bfloat16, torch.int8))
    if (d * storage.element_size()) % 16 or list_size % 32:
        raise ValueError(f"probe_scores: rows of D={d} must be whole 16-byte chunks and "
                         f"L={list_size} a multiple of 32")
    q = queries.contiguous()
    w = weights.to(torch.float32).contiguous()
    pr = probes.to(torch.int32).contiguous()
    dev = kernel_lib.require_cuda(q, storage, w, pr)
    kernel_lib.require_contiguous("probe_scores", storage)
    p = pr.shape[1]
    out = torch.empty((b, p, list_size), dtype=torch.float32, device=dev)
    kernel_lib.launch("probe_scores", "frag_probe_scores", dev,
                      kernel_lib.ptr(q), kernel_lib.ptr(storage), kernel_lib.ptr(w),
                      kernel_lib.ptr(pr), kernel_lib.ptr(out), b, p, nlist, list_size, d, code)
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return out
