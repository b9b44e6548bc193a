"""Query-embedding cache: md5-keyed memory LRU with optional disk spill
(capability of reference rag_backend.py:102-192 SmartEmbeddingCache).

Used for query-side encodes only — ingest embeddings stream straight to the
index, re-encoding them through a cache would just burn host RAM.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np


class EmbeddingCache:
    def __init__(self, max_items: int = 4096, disk_dir: Optional[str | Path] = None) -> None:
        self.max_items = max_items
        self.disk_dir = Path(disk_dir) if disk_dir else None
        if self.disk_dir:
            self.disk_dir.mkdir(parents=True, exist_ok=True)
        self._mem: OrderedDict[str, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # per-model ring of recently-PUT query vectors: every put() came
        # from a real serving query (the cache is query-side only), so this
        # is a free in-distribution sample for IVF nprobe auto-tuning
        # (index/tuning.py tune_nprobe(queries=...); Runtime.tune_indexes
        # wires it). Keyed rings so the per-model indexes tune on their own
        # model's vectors.
        self.recent_cap = 512
        self._recent: dict[str, OrderedDict[str, np.ndarray]] = {}

    @staticmethod
    def _key(model: str, text: str) -> str:
        return hashlib.md5(f"{model}\0{text}".encode("utf-8")).hexdigest()

    def get(self, model: str, text: str) -> Optional[np.ndarray]:
        key = self._key(model, text)
        with self._lock:
            vec = self._mem.get(key)
            if vec is not None:
                self._mem.move_to_end(key)
                self.hits += 1
                return vec
        if self.disk_dir:
            path = self.disk_dir / f"{key}.npy"
            if path.exists():
                try:
                    vec = np.load(path)
                except (OSError, ValueError):
                    vec = None
                if vec is not None:
                    with self._lock:
                        self._put_mem(key, vec)
                        self.hits += 1
                    return vec
        with self._lock:
            self.misses += 1
        return None

    def put(self, model: str, text: str, vec: np.ndarray) -> None:
        key = self._key(model, text)
        vec = np.asarray(vec, np.float32)
        with self._lock:
            self._put_mem(key, vec)
            ring = self._recent.setdefault(model, OrderedDict())
            ring[key] = vec          # dedup repeats of the same query text
            ring.move_to_end(key)
            while len(ring) > self.recent_cap:
                ring.popitem(last=False)
        if self.disk_dir:
            try:
                np.save(self.disk_dir / f"{key}.npy", vec)
            except OSError:
                pass

    def _put_mem(self, key: str, vec: np.ndarray) -> None:
        self._mem[key] = vec
        self._mem.move_to_end(key)
        while len(self._mem) > self.max_items:
            self._mem.popitem(last=False)

    def recent_queries(self, model: str, n: int = 256) -> Optional[np.ndarray]:
        """Up to the last ``n`` distinct query vectors put() for ``model``
        ([m, D] float32, newest last), or None if none were recorded."""
        with self._lock:
            ring = self._recent.get(model)
            if not ring:
                return None
            vecs = list(ring.values())[-n:]
        return np.stack(vecs).astype(np.float32)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "items": len(self._mem),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
        }
