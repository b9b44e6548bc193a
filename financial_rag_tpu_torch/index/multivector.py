"""Multi-vector (late-interaction / ColBERT-style) index.

Counterpart of financial_rag_tpu/index/multivector.py. It computes EXACT
MaxSim over every child, where the reference approximated it by per-query
token HNSW lookups (reference parent_child/multivector_store.py:111-187):

    sims[c, q, t] = q_vec[q] . child_tokens[c, t]
    score[c]      = sum_q max_t sims[c, q, t]

Token storage is a dense [capacity, T_child, D] block (bf16 by default) with
a [capacity, T_child] f32 token mask and a [capacity] f32 valid vector, all
on the device and written in place under the index lock. A search casts the
query to the storage dtype and accumulates the products in f32, as the JAX
package's einsum with ``preferred_element_type=f32`` does; the products are
never rounded back to the storage dtype. The JAX package scans fixed chunks
of children with a running ``lax.top_k``; the port sweeps chunks of as many
children as fit ``SWEEP_BYTES`` of f32 similarities (one GEMM each), keeps
every child's score and selects with one stable descending sort, which gives
the running merge's order: ties go to the lower slot.

MaxSim runs in XLA in the JAX package, outside any Pallas kernel, so it
stays PyTorch tensor ops here. Disabled by default, as in the reference
(the pipeline's and the hybrid retriever's ``multivector_index`` hooks,
gated by CHILD_USE_MULTIVECTOR).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.ops.common import round_up
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("index.multivector")

# the f32 similarities [C, Tq, T] one sweep chunk may hold
SWEEP_BYTES = 64 << 20

_DTYPES = (torch.bfloat16, torch.float32)


def storage_dtype(dtype) -> torch.dtype:
    """torch.bfloat16 or torch.float32, from a torch dtype or a numpy one
    (the JAX package's tests pass ``np.float32``)."""
    out = dtype if isinstance(dtype, torch.dtype) else getattr(torch, np.dtype(dtype).name, None)
    if out not in _DTYPES:
        raise ValueError(f"token storage is bfloat16 or float32, got {dtype!r}")
    return out


def _unit_rows(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)


def maxsim_scores(q: torch.Tensor, tokens: torch.Tensor, tok_mask: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """f32 MaxSim score of each child in a chunk: q [Tq, D] in the storage
    dtype, tokens [C, T, D], tok_mask [C, T], valid [C]. Masked tokens add
    (mask - 1) * 1e5 and dead slots (valid - 1) * 1e5, as the JAX package."""
    c, t, d = tokens.shape
    flat = tokens.reshape(c * t, d)
    if tokens.dtype == torch.float32:
        sims = flat @ q.T
    elif tokens.is_cuda:
        sims = torch.mm(flat, q.T, out_dtype=torch.float32)
    else:   # bf16 products are exact in f32
        sims = flat.float() @ q.float().T
    sims = sims.view(c, t, -1)                                  # [C, T, Tq]
    sims.add_(((tok_mask - 1.0) * 1.0e5)[:, :, None])
    return sims.amax(dim=1).sum(dim=1) + (valid - 1.0) * 1.0e5


class MultiVectorIndex:
    def __init__(
        self,
        dim: int = 384,
        max_child_tokens: int = 128,
        capacity: int = 4096,
        *,
        dtype=torch.bfloat16,
        chunk: int = 256,
        name: str = "children_multivector",
        device=None,
    ) -> None:
        self.dim = dim
        self.max_child_tokens = max_child_tokens
        self.capacity = round_up(capacity, chunk)
        self.chunk = chunk
        self.dtype = storage_dtype(dtype)
        self.name = name
        self.device = resolve_device(device)

        self._tokens = torch.zeros((self.capacity, max_child_tokens, dim), dtype=self.dtype,
                                   device=self.device)
        self._tok_mask = torch.zeros((self.capacity, max_child_tokens), dtype=torch.float32,
                                     device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
        self._ids = np.zeros((self.capacity,), np.int64)
        self._slot_of: Dict[int, int] = {}
        self._next_slot = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._slot_of)

    def count(self) -> int:
        return len(self._slot_of)

    def upsert(self, child_ids: Sequence[int], token_vecs: Sequence[np.ndarray]) -> None:
        """token_vecs[i]: [t_i, D] token embeddings (CLS/SEP already dropped
        by the token encoder); L2-normalised and cut at max_child_tokens
        here, in numpy f32."""
        with self._lock:
            slots = []
            toks = np.zeros((len(child_ids), self.max_child_tokens, self.dim), np.float32)
            masks = np.zeros((len(child_ids), self.max_child_tokens), np.float32)
            for j, (cid, tv) in enumerate(zip(child_ids, token_vecs)):
                cid = int(cid)
                slot = self._slot_of.get(cid)
                if slot is None:
                    slot = self._next_slot
                    self._next_slot += 1
                    if slot >= self.capacity:
                        self._grow()
                    self._slot_of[cid] = slot
                    self._ids[slot] = cid
                slots.append(slot)
                tv = _unit_rows(np.asarray(tv, np.float32)[: self.max_child_tokens])
                toks[j, : len(tv)] = tv
                masks[j, : len(tv)] = 1.0
            if not slots:
                return
            # in place: index_copy_ writes the rows into the existing storage
            at = torch.as_tensor(slots, dtype=torch.long, device=self.device)
            self._tokens.index_copy_(0, at, torch.from_numpy(toks).to(self.device, self.dtype))
            self._tok_mask.index_copy_(0, at, torch.from_numpy(masks).to(self.device))
            self._valid.index_fill_(0, at, 1.0)

    def delete(self, child_ids: Sequence[int]) -> int:
        with self._lock:
            slots = []
            for cid in child_ids:
                slot = self._slot_of.pop(int(cid), None)
                if slot is not None:
                    slots.append(slot)
                    self._ids[slot] = 0
            if slots:
                self._valid.index_fill_(
                    0, torch.as_tensor(slots, dtype=torch.long, device=self.device), 0.0)
            return len(slots)

    def storage_devices(self) -> List[torch.device]:
        """The device that holds the token block (IngestionPipeline.flush
        waits on it)."""
        return [self._tokens.device]

    def _grow(self) -> None:
        pad = self.capacity
        log.info("growing index %s: %d -> %d slots", self.name, pad, 2 * pad)
        self._tokens = torch.cat([self._tokens, torch.zeros(
            (pad, self.max_child_tokens, self.dim), dtype=self.dtype, device=self.device)])
        self._tok_mask = torch.cat([self._tok_mask, torch.zeros(
            (pad, self.max_child_tokens), dtype=torch.float32, device=self.device)])
        self._valid = torch.cat([self._valid, torch.zeros(
            (pad,), dtype=torch.float32, device=self.device)])
        self._ids = np.concatenate([self._ids, np.zeros(pad, np.int64)])
        self.capacity *= 2

    def _sweep_rows(self, tq: int) -> int:
        """Children per sweep chunk: a multiple of ``chunk`` whose [C, Tq, T]
        f32 similarities fit SWEEP_BYTES (at least one ``chunk``)."""
        fit = SWEEP_BYTES // (4 * max(tq, 1) * self.max_child_tokens)
        return min(self.capacity, max(self.chunk, fit // self.chunk * self.chunk))

    def search_aggregate(self, query_token_vecs: np.ndarray, top_k: int = 24) -> List[dict]:
        """Exact MaxSim search. query_token_vecs: [Tq, D]. Returns
        [{score, child_id}, ...] best-first."""
        if not self._slot_of:
            return []
        qv = _unit_rows(query_token_vecs)
        with self._lock:
            ids = self._ids   # a reference: _grow replaces the array
            q = torch.from_numpy(qv).to(self.device, self.dtype)
            rows = self._sweep_rows(qv.shape[0])
            scores = torch.cat([
                maxsim_scores(q, self._tokens[lo:lo + rows], self._tok_mask[lo:lo + rows],
                              self._valid[lo:lo + rows])
                for lo in range(0, self.capacity, rows)])
        k = min(top_k, scores.shape[0])
        top_s, top_i = torch.sort(scores, descending=True, stable=True)
        s, i = top_s[:k].cpu().numpy(), top_i[:k].cpu().numpy()
        return [{"score": float(score), "child_id": int(ids[slot])}
                for score, slot in zip(s, i) if score >= -100.0]
