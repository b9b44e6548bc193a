"""Corpus-sharded flat index over a list of devices.

Counterpart of financial_rag_tpu/parallel/sharded_index.py, with its
surface, slot layout and file format, so a checkpoint saved by either
package loads in the other. The JAX package runs one ``shard_map`` program
over a mesh's 'shard' axis; the port holds one ``index.flat.FlatIndex`` per
shard, each on its shard's device (as ``parallel.mesh.search_devices`` lays
them out), in one process:

- a new id goes to the least-filled shard (round robin), and every shard
  doubles at once when all are full, so the shards keep one capacity and a
  row's global slot is shard x cap_per_shard + its local slot, as in JAX;
- a search launches the same sweep on every shard (``auto``:
  ``bucketed_topk``, K7, on CUDA, as JAX picks ``pallas_bucketed`` on the
  TPU; the exact plain sweep on the CPU), all before any result is read;
  the per-shard candidates are taken in shard-major order and a stable
  top-k keeps the earliest of tied candidates, as JAX's ``all_gather`` +
  ``lax.top_k`` over global slots do (each shard already puts its ties in
  slot order); one device-to-host copy, then each candidate resolves
  through its shard's slot -> id array as the launch saw it.

Upserts, deletes, the launches of a search and the snapshots of a save all
take the index lock, so none of them sees part of an upsert or a growth
across shards; within a shard, ``FlatIndex``'s own lock pairs rows and ids.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.index.flat import TILE, FlatIndex
from financial_rag_tpu_torch.ops.common import round_up
from financial_rag_tpu_torch.ops.topk import stable_topk_indices
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("parallel.sharded_index")

BACKENDS = ("pallas_bucketed", "pallas_exact", "xla")


def merge_shards(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 id_maps: Sequence[np.ndarray], k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shard (scores [B, k], local slots [B, k]) on their devices and
    each shard's slot -> id array -> host (ids [B, k] int64, scores [B, k]
    f32): candidates in shard-major order, a stable top k on the first
    shard's device (ties to the earlier position), one copy to the host,
    and an empty candidate (score < -100, slot -1) as (0, -inf)."""
    dev = parts[0][0].device
    per_shard = parts[0][0].shape[1]
    s_cat = torch.cat([s.to(dev) for s, _ in parts], dim=1)
    i_cat = torch.cat([i.to(dev, torch.int64) for _, i in parts], dim=1)
    pos = stable_topk_indices(s_cat, k)
    host = torch.cat([s_cat.gather(1, pos).double(), i_cat.gather(1, pos).double(),
                      pos.double()], dim=1).cpu().numpy()
    s = host[:, :k].astype(np.float32)
    slot = host[:, k:2 * k].astype(np.int64)
    shard = host[:, 2 * k:].astype(np.int64) // per_shard
    ids = np.zeros(slot.shape, np.int64)
    for i, id_map in enumerate(id_maps):
        at = (shard == i) & (slot >= 0)
        ids[at] = id_map[slot[at]]
    bad = s < -100.0
    ids[bad] = 0
    s[bad] = -np.inf
    return ids, s


class ShardedFlatIndex:
    """Same API as index.flat.FlatIndex, the corpus sharded over ``devices``."""

    def __init__(
        self,
        devices: Sequence,
        dim: int = 384,
        capacity_per_shard: int = 1 << 13,
        *,
        dtype: torch.dtype = torch.bfloat16,
        backend: str = "auto",
        nbuckets: int = 4096,
        name: str = "children_sharded",
    ) -> None:
        """``devices``: one device per shard, as ``search_devices`` lays
        them out (the JAX class takes a mesh)."""
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.n_shards = len(self.devices)
        self.dim = dim
        self.dtype = dtype
        self.name = name
        self.nbuckets = nbuckets
        if backend == "auto":
            backend = "pallas_bucketed" if self.devices[0].type == "cuda" else "xla"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend}")
        self.backend = backend
        # FlatIndex refuses pallas_exact above K6's D on CUDA
        self.shards = [FlatIndex(dim, capacity_per_shard, dtype=dtype, backend=backend,
                                 nbuckets=nbuckets, name=f"{name}_{i}", device=dev)
                       for i, dev in enumerate(self.devices)]
        self._owner: Dict[int, int] = {}   # child_id -> shard
        self._fill = np.zeros(self.n_shards, np.int64)  # next local slot per shard
        self._lock = threading.Lock()

    @property
    def cap_per_shard(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.cap_per_shard * self.n_shards

    def __len__(self) -> int:
        return len(self._owner)

    def count(self) -> int:
        return len(self._owner)

    # ------------------------------------------------------------- updates

    def upsert(self, ids, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32)
        with self._lock:
            routed: Dict[int, List[int]] = {}
            for j, cid in enumerate(ids):
                cid = int(cid)
                shard = self._owner.get(cid)
                if shard is None:
                    shard = int(np.argmin(self._fill))
                    if self._fill[shard] >= self.cap_per_shard:
                        grown = 2 * self.cap_per_shard
                        log.info("growing sharded index %s: %d -> %d slots/shard",
                                 self.name, self.cap_per_shard, grown)
                        for s in self.shards:
                            s.reserve(grown)
                    self._fill[shard] += 1
                    self._owner[cid] = shard
                routed.setdefault(shard, []).append(j)
            for shard, rows in routed.items():
                self.shards[shard].upsert([int(ids[j]) for j in rows], vectors[rows])

    def delete(self, ids) -> int:
        with self._lock:
            routed: Dict[int, List[int]] = {}
            for cid in ids:
                shard = self._owner.pop(int(cid), None)
                if shard is not None:
                    routed.setdefault(shard, []).append(int(cid))
            return sum(self.shards[s].delete(cids) for s, cids in routed.items())

    # -------------------------------------------------------------- search

    def search(self, queries: np.ndarray, top_k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b = queries.shape[0]
        if not self._owner:
            return np.zeros((b, top_k), np.int64), np.full((b, top_k), -np.inf, np.float32)

        host_q = torch.from_numpy(queries)
        on_dev = {dev: host_q.to(dev) for dev in set(self.devices)}
        # every shard's sweep launched, under the lock, before any is read
        with self._lock:
            launched = [s.launch(on_dev[s.device], top_k) for s in self.shards]
        return merge_shards([(sc, sl) for _, sc, sl in launched],
                            [ids for ids, _, _ in launched], top_k)

    # ---------------------------------------------------------- persistence

    def save(self, directory) -> None:
        """The JAX package's npz + manifest: vectors [capacity, D] (int8 as
        its raw values in f32), valid, ids and fill, at global slots. Every
        shard is snapshotted under the lock and copied to the host outside
        it."""
        from financial_rag_tpu_torch.index.persist import (
            atomic_savez, atomic_write_json, dtype_name)

        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        with self._lock:
            snaps = [s.snapshot() for s in self.shards]
            fill_h = self._fill.copy()
            cap = self.cap_per_shard
            n = self.count()
        atomic_savez(d / f"{self.name}.npz",
                     vectors=np.concatenate([v.float().cpu().numpy() for v, _, _ in snaps]),
                     valid=np.concatenate([w.cpu().numpy() for _, w, _ in snaps]),
                     ids=np.concatenate([i for _, _, i in snaps]), fill=fill_h)
        atomic_write_json(d / f"{self.name}.manifest.json", {
            "name": self.name, "dim": self.dim, "n_shards": self.n_shards,
            "cap_per_shard": cap, "count": n, "dtype": dtype_name(self.dtype),
        })

    @classmethod
    def load(cls, directory, devices: Sequence, name: str = "children_sharded",
             **kwargs) -> "ShardedFlatIndex":
        """Reload onto any shard count by replaying the live rows through
        upsert. Also accepts a single-device FlatIndex checkpoint of the same
        name (a manifest without ``cap_per_shard``)."""
        from financial_rag_tpu_torch.index.persist import STR_TO_DTYPE, decode_payload

        d = Path(directory)
        manifest = json.loads((d / f"{name}.manifest.json").read_text())
        data = np.load(d / f"{name}.npz")
        valid, ids, vectors = data["valid"], data["ids"], data["vectors"]
        saved_dtype = manifest.get("dtype")
        if "dtype" not in kwargs and saved_dtype in STR_TO_DTYPE:
            kwargs["dtype"] = STR_TO_DTYPE[saved_dtype]
        cap = manifest.get("cap_per_shard") or round_up(
            max(int((valid > 0).sum()) // len(devices) * 2, TILE), TILE)
        idx = cls(devices, dim=manifest["dim"], capacity_per_shard=cap, name=name, **kwargs)
        live = np.nonzero(valid > 0)[0]
        if len(live):
            idx.upsert(ids[live], decode_payload(vectors[live], saved_dtype,
                                                 weights=valid[live]))
        return idx
