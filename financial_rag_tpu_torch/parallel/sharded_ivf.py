"""Corpus-sharded IVF index: one IVF partition per device.

Counterpart of financial_rag_tpu/parallel/sharded_ivf.py (the 10M-chunk
configuration): vectors route round-robin across shards and keep their
shard; each shard is a self-contained ``index.ivf.IVFIndex`` whose storage
lives on its own device (``parallel.mesh.search_devices``), so K8 runs once
per shard; a search begins every shard before it collects any, then merges
the k x n_shards candidates on the host, ties to the lower shard and then to
the shard's own order. Files are the JAX package's: one ``{name}_{i}`` IVF
checkpoint per shard.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.index.ivf import IVFIndex
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("parallel.sharded_ivf")


class ShardedIVFIndex:
    def __init__(
        self,
        devices: Sequence,
        dim: int = 384,
        nlist: int = 256,
        list_size: int = 256,
        nprobe: int = 32,
        *,
        dtype: torch.dtype = torch.bfloat16,
        name: str = "children_ivf_sharded",
    ) -> None:
        """``devices``: one device per shard, as ``search_devices`` lays
        them out (the JAX class takes a shard count)."""
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.n_shards = len(self.devices)
        self.dim = dim
        self.name = name
        self.shards: List[IVFIndex] = [
            IVFIndex(dim=dim, nlist=nlist, list_size=list_size, nprobe=nprobe,
                     dtype=dtype, name=f"{name}_{i}", device=dev)
            for i, dev in enumerate(self.devices)
        ]
        self._owner: Dict[int, int] = {}   # child_id -> shard
        self._rr = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._owner)

    def count(self) -> int:
        return len(self._owner)

    @property
    def is_trained(self) -> bool:
        return all(s.is_trained for s in self.shards)

    @property
    def nlist(self) -> int:
        return self.shards[0].nlist

    @property
    def nprobe(self) -> int:
        return self.shards[0].nprobe

    @nprobe.setter
    def nprobe(self, value: int) -> None:
        for s in self.shards:
            s.nprobe = min(int(value), s.nlist)

    def train(self, vectors: np.ndarray, iters: int = 12, seed: int = 0) -> None:
        """All shards learn centroids from the same sample (routing is
        round-robin, so every shard sees the same distribution)."""
        for i, shard in enumerate(self.shards):
            shard.train(vectors, iters=iters, seed=seed + i)

    def upsert(self, ids: Sequence[int], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32)
        with self._lock:
            routed: Dict[int, Tuple[List[int], List[int]]] = {}
            for j, cid in enumerate(ids):
                cid = int(cid)
                shard = self._owner.get(cid)
                if shard is None:
                    shard = self._rr % self.n_shards
                    self._rr += 1
                    self._owner[cid] = shard
                routed.setdefault(shard, ([], []))[0].append(cid)
                routed[shard][1].append(j)
        for shard, (cids, rows) in routed.items():
            self.shards[shard].upsert(cids, vectors[rows])

    def delete(self, ids: Sequence[int]) -> int:
        removed = 0
        with self._lock:
            routed: Dict[int, List[int]] = {}
            for cid in ids:
                shard = self._owner.pop(int(cid), None)
                if shard is not None:
                    routed.setdefault(shard, []).append(int(cid))
        for shard, cids in routed.items():
            removed += self.shards[shard].delete(cids)
        return removed

    def search(self, queries: np.ndarray, top_k: int, *,
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Every shard's probe launched before any is collected, then a
        stable host merge: ties to the lower shard, then the shard's order."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b = queries.shape[0]
        if not self._owner:
            return np.zeros((b, top_k), np.int64), np.full((b, top_k), -np.inf, np.float32)

        begun = [(i, shard.search_begin(queries, top_k, nprobe=nprobe))
                 for i, shard in enumerate(self.shards) if len(shard)]
        all_ids = np.zeros((self.n_shards, b, top_k), np.int64)
        all_scores = np.full((self.n_shards, b, top_k), -np.inf, np.float32)
        for i, materialize in begun:
            all_ids[i], all_scores[i] = materialize()

        cat_ids = all_ids.transpose(1, 0, 2).reshape(b, -1)
        cat_s = all_scores.transpose(1, 0, 2).reshape(b, -1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :top_k]
        return (np.take_along_axis(cat_ids, order, axis=1),
                np.take_along_axis(cat_s, order, axis=1))

    def retrain(self, iters: int = 12, seed: int = 0) -> None:
        """Re-fit every non-empty shard's centroids on its own contents."""
        for i, shard in enumerate(self.shards):
            if len(shard):
                shard.retrain(iters=iters, seed=seed + i)

    # ------------------------------------------------------------- tuning

    def sample_vectors(self, n: int, seed: int = 0) -> np.ndarray:
        """Up to ``n`` live vectors sampled across shards, in proportion to
        each shard's fill."""
        total = self.count()
        parts = []
        for i, shard in enumerate(self.shards):
            if not len(shard):
                continue
            want = max(1, round(n * len(shard) / total))
            parts.append(shard.sample_vectors(want, seed=seed + i))
        out = np.concatenate(parts, axis=0) if parts else np.zeros((0, self.dim), np.float32)
        if out.shape[0] > n:
            rng = np.random.default_rng(seed)
            out = out[rng.choice(out.shape[0], size=n, replace=False)]
        return out

    def tune_nprobe(self, **kwargs) -> dict:
        """Tune the shared nprobe over the merged search; the chosen value
        is applied to every shard."""
        from financial_rag_tpu_torch.index.tuning import tune_nprobe

        return tune_nprobe(self, **kwargs)

    # ---------------------------------------------------------- persistence

    def save(self, directory) -> None:
        for shard in self.shards:
            shard.save(directory)

    @classmethod
    def load(cls, directory, devices: Sequence,
             name: str = "children_ivf_sharded") -> "ShardedIVFIndex":
        from financial_rag_tpu_torch.index.persist import STR_TO_DTYPE

        m = json.loads((Path(directory) / f"{name}_0.manifest.json").read_text())
        idx = cls(devices, dim=m["dim"], nlist=m["nlist"], list_size=m["list_size"],
                  nprobe=m["nprobe"], dtype=STR_TO_DTYPE.get(m.get("dtype"), torch.bfloat16),
                  name=name)
        idx.shards = [IVFIndex.load(directory, name=f"{name}_{i}", device=dev)
                      for i, dev in enumerate(idx.devices)]
        for i, shard in enumerate(idx.shards):
            for cid in shard._loc_of:
                idx._owner[cid] = i
        idx._rr = len(idx._owner)
        return idx
