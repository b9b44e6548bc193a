"""Device-resident flat cosine index.

Counterpart of financial_rag_tpu/index/flat.py: vectors live on the device
as one preallocated [capacity, D] matrix plus a [capacity] validity/weight
vector; a search is one fused sweep (ops/topk.py); ids are host-side (slot
-> child_id array and child_id -> slot dict); capacity stays a multiple of
the kernel tile and doubles on demand; persistence is an .npz of vectors +
ids with a JSON manifest in the JAX package's format.

Backends keep the JAX package's names, so manifests mean the same thing:
``auto`` resolves to ``pallas_fused`` on a CUDA device and to ``xla`` (the
exact plain sweep) on the CPU. ``pallas_fused`` takes the packed sweep (K4)
for a float corpus and the bucketed sweep with the fused top-k (K5) for an
int8 one; ``pallas_bucketed`` takes K7 and ``pallas_exact`` K6. On the CPU
each kernel's wrapper runs its plain version.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.ops.common import round_up
from financial_rag_tpu_torch.ops.topk import (
    EXACT_MAX_D,
    INT8_SCALE,
    bucketed_topk,
    bucketed_topk_fused,
    packed_topk_fused,
    topk_matmul,
    topk_matmul_reference,
)
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("index.flat")

TILE = 1024  # kernel corpus tile; capacity is always a multiple
BACKENDS = ("pallas_fused", "pallas_bucketed", "pallas_exact", "xla")


def _encode_payload_device(v: torch.Tensor, dtype: torch.dtype):
    """On-device normalize + storage encode (mirrors persist.encode_payload):
    the ingest path hands encoder outputs straight to the index without a
    device->host->device round trip."""
    v = v.float()
    v = v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)
    if dtype == torch.int8:
        m = v.abs().amax(dim=1).clamp_min(1e-12)
        q = torch.round(v * (INT8_SCALE / m[:, None])).clamp(-127, 127).to(torch.int8)
        return q, (m / INT8_SCALE).float()
    return v.to(dtype), torch.ones(v.shape[0], dtype=torch.float32, device=v.device)


class FlatIndex:
    """Exact / near-exact cosine top-k over a device-resident corpus."""

    def __init__(
        self,
        dim: int = 384,
        capacity: int = 1 << 14,
        *,
        dtype: torch.dtype = torch.bfloat16,
        backend: str = "auto",   # auto | pallas_fused | pallas_bucketed | pallas_exact | xla
        nbuckets: int = 4096,
        name: str = "children",
        device=None,
    ) -> None:
        self.dim = dim
        self.capacity = round_up(capacity, TILE)
        self.dtype = dtype
        self.name = name
        self.nbuckets = nbuckets
        self.device = resolve_device(device)
        if backend == "auto":
            backend = "pallas_fused" if self.device.type == "cuda" else "xla"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend}")
        self.backend = backend
        if (self.device.type == "cuda" and backend == "pallas_exact"
                and dtype != torch.float32 and dim > EXACT_MAX_D):
            raise NotImplementedError(
                f"backend pallas_exact: K6's int8/bf16 sweep takes D <= {EXACT_MAX_D}, "
                f"the index has dim {dim}")

        self._vectors = torch.zeros((self.capacity, dim), dtype=dtype, device=self.device)
        self._valid = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
        self._ids = np.zeros((self.capacity,), np.int64)
        self._slot_of: Dict[int, int] = {}
        self._next_slot = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ API

    def __len__(self) -> int:
        return len(self._slot_of)

    def count(self) -> int:
        return len(self._slot_of)

    # class flag (not hasattr — wrappers delegate attribute lookups): the
    # ingest pipeline hands device-resident encoder outputs straight to upsert()
    supports_device_upsert = True

    def upsert(self, ids: Sequence[int], vectors) -> None:
        """Insert or overwrite vectors. ids: int64 child ids, vectors [N, D]
        host numpy OR a torch tensor (L2-normalized by the encoder;
        normalized again on the storage path defensively)."""
        on_device = isinstance(vectors, torch.Tensor)
        if not on_device:
            vectors = np.asarray(vectors, np.float32)
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = vectors / np.maximum(norms, 1e-12)
        assert vectors.ndim == 2 and vectors.shape[1] == self.dim, vectors.shape
        assert len(ids) == vectors.shape[0]

        with self._lock:
            slots = np.empty(len(ids), np.int64)
            for j, cid in enumerate(ids):
                cid = int(cid)
                slot = self._slot_of.get(cid)
                if slot is None:
                    slot = self._next_slot
                    self._next_slot += 1
                    if slot >= self.capacity:
                        self._grow()
                    self._slot_of[cid] = slot
                    self._ids[slot] = cid
                slots[j] = slot
            self._scatter(slots, vectors, on_device=on_device)

    def delete(self, ids: Sequence[int]) -> int:
        """Invalidate ids; returns number removed. Slots are not reused
        (tombstoned) until a compact."""
        with self._lock:
            slots = []
            for cid in ids:
                slot = self._slot_of.pop(int(cid), None)
                if slot is not None:
                    slots.append(slot)
                    self._ids[slot] = 0
            if slots:
                self._valid[torch.as_tensor(slots, device=self.device)] = 0.0
            return len(slots)

    def compact(self) -> int:
        """Rebuild the index dropping tombstoned slots; returns slots
        reclaimed. Changes slot assignment (ids are stable)."""
        with self._lock:
            live = [(cid, slot) for cid, slot in self._slot_of.items()]
            reclaimed = self._next_slot - len(live)
            if reclaimed <= 0:
                return 0
            live.sort(key=lambda cs: cs[1])  # preserve insertion order
            old = torch.as_tensor([s for _, s in live], dtype=torch.long, device=self.device)
            vectors = self._vectors[old]
            weights = self._valid[old]

            self._vectors = torch.zeros((self.capacity, self.dim), dtype=self.dtype,
                                        device=self.device)
            self._valid = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
            # REPLACE (never renumber in place): deferred materializers
            # resolve ids through a reference snapshotted at dispatch
            self._ids = np.zeros((self.capacity,), np.int64)
            self._slot_of = {}
            for new_slot, (cid, _) in enumerate(live):
                self._slot_of[cid] = new_slot
                self._ids[new_slot] = cid
            self._next_slot = len(live)
            if live:
                self._vectors[:len(live)] = vectors
                # carry each row's dequantization weight with it
                self._valid[:len(live)] = weights
            log.info("compacted index %s: reclaimed %d slots", self.name, reclaimed)
            return reclaimed

    # class-level flags (not hasattr), as in the JAX package
    supports_search_begin = True
    # search_begin takes device tensors without a host round trip — a
    # chained encoder output feeds the sweep directly (retrieval/hybrid.py)
    accepts_device_queries = True

    def search_begin(self, queries, top_k: int):
        """Launch a batched search WITHOUT materializing: returns a
        :class:`SearchPending` whose ``get()`` (or ``pending.collect`` over
        several indexes) pulls (child_ids [B, k] int64, scores [B, k] f32)
        in ONE device-to-host copy. ``queries`` may be a host array or a
        [B, D] tensor (e.g. a chained encoder output)."""
        from financial_rag_tpu_torch.index.pending import SearchPending, ready

        if isinstance(queries, torch.Tensor):
            queries = queries.to(device=self.device, dtype=torch.float32)
        else:
            queries = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
        if queries.ndim == 1:
            queries = queries[None, :]
        b = queries.shape[0]
        if not self._slot_of:
            return ready(np.zeros((b, top_k), np.int64),
                         np.full((b, top_k), -np.inf, np.float32))

        ids_host, scores, slots = self.launch(queries, top_k)

        def finish(host):
            scores_h, slots_h = host
            scores_h = np.asarray(scores_h)
            slots_h = np.asarray(slots_h)
            ids = np.where(slots_h >= 0, ids_host[np.maximum(slots_h, 0)], 0)
            bad = scores_h < -100.0
            ids[bad] = 0
            scores_h = scores_h.copy()
            scores_h[bad] = -np.inf
            return ids.astype(np.int64), scores_h

        return SearchPending((scores, slots), finish)

    def search(self, queries, top_k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batched search. queries [B, D] -> (child_ids [B, k] int64,
        scores [B, k] f32). Empty slots never surface (score < -100 filtered
        to id 0 / score -inf)."""
        return self.search_begin(queries, top_k).get()

    def launch(self, queries: torch.Tensor, top_k: int):
        """Launch the sweep on [B, D] device queries without reading it:
        (the slot -> id array, scores [B, k], slots [B, k]). Under the lock:
        the in-place upsert must not race the sweep's launch. The _ids
        REFERENCE is snapshotted with the launch: compact() and _grow()
        replace the array, so a deferred reader resolves through the
        numbering its scores were computed under."""
        with self._lock:
            return (self._ids, *self._dispatch(queries, top_k))

    def reserve(self, capacity: int) -> None:
        """Double the capacity until ``capacity`` slots fit."""
        with self._lock:
            while self.capacity < capacity:
                self._grow()

    def snapshot(self):
        """(vectors, valid, slot -> id array) over the whole capacity, cloned
        under the lock (stream-ordered before any later in-place write), the
        tensors still on the device."""
        with self._lock:
            return self._vectors.clone(), self._valid.clone(), self._ids.copy()

    # ------------------------------------------------------------ internals

    def _scatter(self, slots: np.ndarray, vectors, on_device: bool = False) -> None:
        from financial_rag_tpu_torch.index.persist import encode_payload

        if not len(slots):  # empty ingest batch (document with no children)
            return
        if on_device:
            payload, weights = _encode_payload_device(vectors.to(self.device), self.dtype)
        else:
            payload, weights = encode_payload(vectors, self.dtype, self.device)
            weights = torch.from_numpy(weights).to(self.device)
        # in place under the caller's lock: index_copy_ writes the rows
        # into the existing storage, where the JAX package donates the
        # buffers to a jitted scatter; peak device memory stays at 1x storage
        at = torch.from_numpy(slots).to(self.device)
        self._vectors.index_copy_(0, at, payload)
        self._valid.index_copy_(0, at, weights)

    def _grow(self) -> None:
        new_cap = self.capacity * 2
        log.info("growing index %s: %d -> %d slots", self.name, self.capacity, new_cap)
        extra = new_cap - self.capacity
        self._vectors = torch.cat([self._vectors, torch.zeros(
            (extra, self.dim), dtype=self.dtype, device=self.device)])
        self._valid = torch.cat([self._valid, torch.zeros(
            (extra,), dtype=torch.float32, device=self.device)])
        self._ids = np.concatenate([self._ids, np.zeros(extra, np.int64)])
        self.capacity = new_cap

    def _dispatch(self, queries: torch.Tensor, k: int):
        x, v = self._vectors, self._valid
        if self.backend == "pallas_fused":
            if self.dtype == torch.int8:
                # int8 needs the per-row dequantization weight inside the dot
                return bucketed_topk_fused(queries, x, v, k, nbuckets=self.nbuckets)
            return packed_topk_fused(queries, x, v, k)
        if self.backend == "pallas_bucketed":
            return bucketed_topk(queries, x, v, k, nbuckets=self.nbuckets)
        if self.backend == "pallas_exact":
            return topk_matmul(queries, x, v, k)
        return topk_matmul_reference(queries, x, v, k)

    # ---------------------------------------------------------- persistence

    def save(self, directory: str | Path) -> None:
        from financial_rag_tpu_torch.index.persist import (
            atomic_savez, atomic_write_json, dtype_name)

        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        with self._lock:
            used = self._next_slot
            vectors_h = self._vectors[:used].float().cpu().numpy()
            valid_h = self._valid[:used].cpu().numpy()
            ids_h = self._ids[:used].copy()
        # int8 payloads persist as their raw quantized values (cast to f32
        # in the npz); the manifest dtype tells load() how to decode them
        atomic_savez(d / f"{self.name}.npz", vectors=vectors_h, valid=valid_h, ids=ids_h)
        atomic_write_json(d / f"{self.name}.manifest.json", {
            "name": self.name,
            "dim": self.dim,
            "count": self.count(),
            "used_slots": used,
            "backend": self.backend,
            "nbuckets": self.nbuckets,
            "dtype": dtype_name(self.dtype),
        })

    @classmethod
    def load(cls, directory: str | Path, name: str = "children", **kwargs) -> "FlatIndex":
        """Reload. Storage dtype / nbuckets come from the manifest unless the
        caller overrides them; int8 payloads are rescaled into unit-vector
        space first so a dtype change between save and load re-quantizes
        correctly. ``backend`` is not taken from the manifest: it depends on
        the device and is re-resolved by the constructor's "auto"."""
        from financial_rag_tpu_torch.index.persist import (
            STR_TO_DTYPE, decode_payload, encode_payload)

        d = Path(directory)
        data = np.load(d / f"{name}.npz")
        vectors, valid, ids = data["vectors"], data["valid"], data["ids"]
        manifest_path = d / f"{name}.manifest.json"
        manifest = json.loads(manifest_path.read_text()) if manifest_path.exists() else {}
        saved_dtype = manifest.get("dtype")
        if "dtype" not in kwargs and saved_dtype in STR_TO_DTYPE:
            kwargs["dtype"] = STR_TO_DTYPE[saved_dtype]
        if "nbuckets" not in kwargs and "nbuckets" in manifest:
            kwargs["nbuckets"] = manifest["nbuckets"]
        used = vectors.shape[0]
        dim = vectors.shape[1] if used else kwargs.pop("dim", 384)
        kwargs.pop("dim", None)  # saved dim wins over a caller-provided one
        idx = cls(dim=dim, capacity=max(used, TILE), name=name, **kwargs)
        if used:
            unit = decode_payload(vectors, saved_dtype, weights=valid)
            payload, weights = encode_payload(unit, idx.dtype, idx.device)
            idx._vectors[:used] = payload
            # re-encoded weights for live slots; tombstones stay 0
            idx._valid[:used] = torch.from_numpy(
                np.where(valid > 0, weights, 0.0).astype(np.float32)).to(idx.device)
            idx._ids[:used] = ids
            idx._next_slot = used
            idx._slot_of = {int(cid): s for s, cid in enumerate(ids) if valid[s] > 0}
        return idx
