"""IVF (inverted-file) cosine index with on-device k-means.

Counterpart of financial_rag_tpu/index/ivf.py, with the same grouped storage,
search, mutation and persistence contract, so an index saved by either
package loads in the other:

- grouped storage [nlist, list_size, D] on the device: every posting list is
  a fixed-size padded tile, so each probe reads one contiguous block;
- spherical k-means on the device (k-means++ seeding by the Gumbel-max
  trick, Lloyd's iterations of one matmul-argmax assignment plus an
  ``index_add_`` update);
- search: queries x centroids matmul -> stable top-nprobe lists -> the probe
  kernel (ops/ivf_probe.py, K8) -> stable top-k over the probed subset;
- int8 storage with the flat index's per-vector dequantization weights
  riding in the validity array.

Where the JAX package donates the storage to a jitted scatter, the port
writes in place (``index_put_``) under the index lock. ``jax.random`` and
``torch.Generator`` draw different numbers from one seed, so the two
packages' k-means start from different points; tests carry centroids
across instead.
"""

from __future__ import annotations

import json
import math
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.ops.common import round_up
from financial_rag_tpu_torch.ops.ivf_probe import probe_scores
from financial_rag_tpu_torch.ops.topk import NEG, quantize_queries, stable_topk_indices
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("index.ivf")


# ----------------------------------------------------------------- k-means

def _kmeans_pp_init(xd: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ seeding on cosine distance, on the device: each round draws
    the next centroid with probability proportional to d² by the Gumbel-max
    trick (argmax(log d² + Gumbel)), so the init is k matvecs and no host
    round trips."""
    n, d = xd.shape
    gen = torch.Generator(device=xd.device)
    gen.manual_seed(seed)
    first = int(torch.randint(0, n, (1,), generator=gen, device=xd.device).item())
    c = torch.zeros((k, d), dtype=torch.float32, device=xd.device)
    c[0] = xd[first]
    best_sim = xd @ xd[first]
    for i in range(1, k):
        d2 = torch.clamp(1.0 - best_sim, min=1e-9)
        u = torch.rand(n, generator=gen, device=xd.device)
        gumbel = -torch.log(-torch.log(u))
        nxt = torch.argmax(torch.log(d2) + gumbel)
        c[i] = xd[nxt]
        best_sim = torch.maximum(best_sim, xd @ xd[nxt])
    return c


def _lloyd_step(xa: torch.Tensor, c: torch.Tensor):
    """One assignment + mean update; empty clusters keep their centroid.
    Returns (centroids, counts, per-point best similarity)."""
    k = c.shape[0]
    sims = xa @ c.T                                                    # [N, k]
    fit = sims.max(dim=1).values                     # per-point best similarity
    assign = torch.argmax(sims, dim=1)               # first maximum, as jnp.argmax
    sums = torch.zeros_like(c).index_add_(0, assign, xa)
    counts = torch.bincount(assign, minlength=k).float()
    new_c = sums / torch.clamp(counts[:, None], min=1e-9)
    new_c = new_c / torch.clamp(new_c.norm(dim=1, keepdim=True), min=1e-12)
    new_c = torch.where(counts[:, None] > 0, new_c, c)
    return new_c, counts, fit


def kmeans(
    vectors: np.ndarray,       # [N, D] (will be L2-normalized)
    k: int,
    iters: int = 12,
    seed: int = 0,
    n_init: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Spherical k-means: device k-means++ init, device Lloyd's iterations,
    empty-cluster reseeding to the worst-fit points, and ``n_init`` restarts
    keeping the run with the best quantization (mean max-sim). ``n_init``
    defaults to 3 for small k and 1 for k >= 1024. Returns unit-norm
    centroids [k, D] (host f32)."""
    if n_init is None:
        n_init = 3 if k < 1024 else 1
    dev = resolve_device(device)
    x = np.asarray(vectors, np.float32)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    n, _ = x.shape
    xd = torch.from_numpy(x).to(dev)

    best_c, best_score = None, -np.inf
    for trial in range(max(n_init, 1)):
        if n >= k:
            c = _kmeans_pp_init(xd, k, seed + 7919 * trial)
        else:
            rng = np.random.default_rng(seed + 7919 * trial)
            c = torch.from_numpy(x[rng.choice(n, size=k)]).to(dev)
        fit = None
        for _ in range(iters):
            c, counts, fit = _lloyd_step(xd, c)
            empty = np.nonzero(counts.cpu().numpy() == 0)[0]
            if len(empty):
                # reseed each empty cluster at the point fitting worst; with
                # fewer points than empty clusters (a tiny first streaming
                # batch, k > n) cycle the points
                worst = np.argsort(fit.cpu().numpy())[: len(empty)]
                if len(worst) < len(empty):
                    worst = np.resize(worst, len(empty))
                c[torch.from_numpy(empty).to(dev)] = xd[torch.from_numpy(worst).to(dev)]
        score = float(fit.mean().item())
        if score > best_score:
            best_c, best_score = c.cpu().numpy(), score
    return best_c


def recommended_nlist(capacity: int) -> int:
    """Power-of-two nlist ≈ 4·√N, clamped to [64, 65536]: it balances the
    centroid scan (grows with nlist) against the probed lists (shrink with
    nlist)."""
    target = 4.0 * math.sqrt(max(capacity, 1))
    return max(64, min(1 << 16, 1 << round(math.log2(target))))


# ------------------------------------------------------------------- index

class IVFIndex:
    def __init__(
        self,
        dim: int = 384,
        nlist: int = 256,
        list_size: int = 256,
        nprobe: int = 32,
        *,
        dtype: torch.dtype = torch.bfloat16,
        name: str = "children_ivf",
        device=None,
    ) -> None:
        self.dim = dim
        self.nlist = nlist
        self.list_size = round_up(list_size, 128)
        self.nprobe = min(nprobe, nlist)
        self.dtype = dtype
        self.name = name
        self.device = resolve_device(device)

        self.centroids: Optional[torch.Tensor] = None       # [nlist, D] f32
        self._storage = torch.zeros((nlist, self.list_size, dim), dtype=dtype, device=self.device)
        self._valid = torch.zeros((nlist, self.list_size), dtype=torch.float32, device=self.device)
        self._ids = np.zeros((nlist, self.list_size), np.int64)
        self._fill = np.zeros(nlist, np.int32)              # high-water slot per list
        # tombstoned slots awaiting reuse, per list: delete pushes, upsert
        # pops before advancing the high-water mark
        self._free: Dict[int, List[int]] = {}
        self._loc_of: Dict[int, Tuple[int, int]] = {}       # child_id -> (list, slot)
        # mutation epoch, bumped by every upsert/delete/retrain as its last
        # step under the lock: a deferred search resolves device hits
        # through the host _ids map and re-runs if the epoch moved
        self._mut = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._loc_of)

    def count(self) -> int:
        return len(self._loc_of)

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def train(self, vectors: np.ndarray, iters: int = 12, seed: int = 0) -> None:
        self.centroids = torch.from_numpy(
            kmeans(vectors, self.nlist, iters=iters, seed=seed, device=self.device)).to(self.device)

    # ------------------------------------------------------------- updates

    def _assignments(self, vectors: np.ndarray, depth: int = 4,
                     chunk: int = 8192) -> np.ndarray:
        """Top-``depth`` candidate lists per vector (for overflow fallback),
        on the device, chunked so the [chunk, nlist] sims stay small."""
        depth = min(depth, self.nlist)
        outs = []
        for lo in range(0, len(vectors), chunk):
            v = torch.from_numpy(np.asarray(vectors[lo: lo + chunk], np.float32)).to(self.device)
            outs.append(stable_topk_indices(v @ self.centroids.T, depth).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def upsert(self, ids: Sequence[int], vectors: np.ndarray) -> None:
        if not len(ids):  # empty ingest batch (document with no children)
            return
        if not self.is_trained:
            # auto-train on the first batch (a small first batch still
            # works: duplicated centroids are handled by the empty-cluster rule)
            log.info("IVF auto-training on first upsert batch (%d vectors)", len(vectors))
            self.train(np.asarray(vectors, np.float32))
        vectors = np.asarray(vectors, np.float32)
        vectors = vectors / np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)
        cand = self._assignments(vectors)

        with self._lock:
            lists, slots = [], []
            for j, cid in enumerate(ids):
                cid = int(cid)
                old = self._loc_of.get(cid)
                if old is not None:
                    li, sl = old
                else:
                    li = sl = None
                    for c in cand[j]:
                        free = self._free.get(int(c))
                        if free:
                            li, sl = int(c), free.pop()
                            break
                        if self._fill[c] < self.list_size:
                            li, sl = int(c), int(self._fill[c])
                            self._fill[c] += 1
                            break
                    if li is None:
                        li, sl = self._grow_and_place(int(cand[j][0]))
                    self._loc_of[cid] = (li, sl)
                    self._ids[li, sl] = cid
                lists.append(li)
                slots.append(sl)

            from financial_rag_tpu_torch.index.persist import encode_payload

            # in place under the lock; the validity array doubles as the
            # per-row dequantization weight (1.0 for floats, max|v|/127 for int8)
            payload, weights = encode_payload(vectors, self.dtype, self.device)
            at = (torch.as_tensor(lists, dtype=torch.long, device=self.device),
                  torch.as_tensor(slots, dtype=torch.long, device=self.device))
            self._storage.index_put_(at, payload)
            self._valid.index_put_(at, torch.from_numpy(weights).to(self.device))
            self._mut += 1

    def _grow_and_place(self, li: int) -> Tuple[int, int]:
        new_ls = self.list_size * 2
        log.info("growing IVF lists: %d -> %d", self.list_size, new_ls)
        pad = new_ls - self.list_size
        self._storage = torch.cat([self._storage, torch.zeros(
            (self.nlist, pad, self.dim), dtype=self.dtype, device=self.device)], dim=1)
        self._valid = torch.cat([self._valid, torch.zeros(
            (self.nlist, pad), dtype=torch.float32, device=self.device)], dim=1)
        self._ids = np.pad(self._ids, ((0, 0), (0, pad)))
        self.list_size = new_ls
        sl = int(self._fill[li])
        self._fill[li] += 1
        return li, sl

    def retrain(self, iters: int = 12, seed: int = 0) -> None:
        """Re-fit centroids on the current contents and reassign every
        vector (k-means refresh for corpus drift). Ids are stable."""
        with self._lock:
            live = sorted(self._loc_of.items(), key=lambda kv: kv[1])
            if not live:
                return
            ids = [cid for cid, _ in live]
            locs = torch.as_tensor(np.asarray([loc for _, loc in live]), dtype=torch.long,
                                   device=self.device)
            # raw payload x per-row weight == unit vector for every dtype
            vecs = (self._storage[locs[:, 0], locs[:, 1]].float()
                    * self._valid[locs[:, 0], locs[:, 1], None]).cpu().numpy()

            self.centroids = None
            self._storage.zero_()
            self._valid.zero_()
            self._ids[:] = 0
            self._fill[:] = 0
            self._free = {}
            self._loc_of = {}
            self._mut += 1
        self.train(vecs, iters=iters, seed=seed)
        self.upsert(ids, vecs)
        log.info("IVF retrained on %d vectors (%d lists)", len(ids), self.nlist)

    def delete(self, ids: Sequence[int]) -> int:
        with self._lock:
            lists, slots = [], []
            for cid in ids:
                loc = self._loc_of.pop(int(cid), None)
                if loc is not None:
                    lists.append(loc[0])
                    slots.append(loc[1])
                    self._ids[loc[0], loc[1]] = 0
                    self._free.setdefault(loc[0], []).append(loc[1])
            if lists:
                self._valid[torch.as_tensor(lists, dtype=torch.long, device=self.device),
                            torch.as_tensor(slots, dtype=torch.long, device=self.device)] = 0.0
                self._mut += 1
            return len(lists)

    # -------------------------------------------------------------- search

    def _build_search(self, k: int, nprobe: int):
        """The search program for (k, nprobe) at the current list_size; the
        storage, weights and centroids are arguments, so mutations are seen
        by every later call."""
        ls = self.list_size

        def run(queries, storage, valid, centroids):             # [B, D] f32
            q = queries.float()
            probes = stable_topk_indices(q @ centroids.T, nprobe)          # [B, P]
            qq, qscale = quantize_queries(q, storage.dtype)
            scores = probe_scores(qq, storage, valid, probes)              # [B, P, L] f32
            flat = scores.reshape(q.shape[0], nprobe * ls)
            pos = stable_topk_indices(flat, k)
            top_s = flat.gather(1, pos)
            if qscale is not None:
                # rescale live raw int8 scores; masked slots (-1e5 < NEG)
                # stay below the downstream validity threshold
                top_s = torch.where(top_s > NEG, top_s * qscale, top_s)
            l_idx = probes.gather(1, pos // ls)
            return top_s, l_idx, pos % ls

        return run

    def search_begin(self, queries, top_k: int, *, nprobe: Optional[int] = None,
                     chunk: int = 16):
        """Launch-only search: enqueue every device chunk and return a
        zero-arg materializer producing (ids [B, k] int64, scores [B, k]
        f32). Callers driving several indexes begin them all before
        materializing any."""
        assert self.is_trained
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b = queries.shape[0]
        nprobe = nprobe or self.nprobe
        if not self._loc_of:
            return lambda: (np.zeros((b, top_k), np.int64),
                            np.full((b, top_k), -np.inf, np.float32))

        # pad small request batches to 8 rather than the full serving chunk:
        # every padded row streams nprobe full lists
        if b <= 8 < chunk:
            chunk = 8

        def padded(lo):
            qa = queries[lo: lo + chunk]
            pad = chunk - qa.shape[0]
            if pad:
                qa = np.pad(qa, ((0, pad), (0, 0)))
            return torch.from_numpy(qa).to(self.device), pad

        def dispatch():
            pending = []   # (lo, pad, device (s, li, sl))
            mut0 = None
            for lo in range(0, b, chunk):
                qa, pad = padded(lo)
                # program choice AND launch under the lock: list_size may
                # grow (_grow_and_place) and the in-place upsert must not
                # race the probe kernel's reads
                with self._lock:
                    if mut0 is None:
                        mut0 = self._mut
                    run = self._build_search(top_k, nprobe)
                    out = run(qa, self._storage, self._valid, self.centroids)
                pending.append((lo, pad, out))
            return mut0, pending

        def resolve(pending):
            out_ids = np.zeros((b, top_k), np.int64)
            out_scores = np.full((b, top_k), -np.inf, np.float32)
            for lo, pad, (s, li, sl) in pending:
                s, li, sl = (t.cpu().numpy().copy() for t in (s, li, sl))
                if pad:
                    s, li, sl = s[:-pad], li[:-pad], sl[:-pad]
                ids = self._ids[li, sl]
                bad = s < -100.0
                ids[bad] = 0
                s[bad] = -np.inf
                out_ids[lo: lo + len(ids)] = ids
                out_scores[lo: lo + len(s)] = s
            return out_ids, out_scores

        mut0, pending = dispatch()

        def materialize() -> Tuple[np.ndarray, np.ndarray]:
            # hits resolve through the HOST _ids map; a mutation between
            # dispatch and this resolution (tombstone-slot reuse, retrain)
            # means that map no longer describes the storage the scores came
            # from. Detect it by the epoch and re-run: twice optimistically,
            # then once atomically under the lock.
            m0, p = mut0, pending
            for _ in range(2):
                out = resolve(p)
                # epoch re-check UNDER THE LOCK: every mutator rewrites
                # _ids/_free in place holding the lock and bumps _mut as its
                # last step, so a lock-free check could pass while a writer
                # has rewritten _ids but not yet bumped
                with self._lock:
                    clean = self._mut == m0
                if clean:
                    return out
                m0, p = dispatch()
            with self._lock:
                # fully consistent: mutations take this lock
                run = self._build_search(top_k, nprobe)
                pending_now = []
                for lo in range(0, b, chunk):
                    qa, pad = padded(lo)
                    pending_now.append(
                        (lo, pad, run(qa, self._storage, self._valid, self.centroids)))
                return resolve(pending_now)

        return materialize

    def search(self, queries, top_k: int, *, nprobe: Optional[int] = None,
               chunk: int = 16) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (child_ids [B, k] int64, scores [B, k] f32)."""
        return self.search_begin(queries, top_k, nprobe=nprobe, chunk=chunk)()

    # ------------------------------------------------------------- tuning

    def sample_vectors(self, n: int, seed: int = 0) -> np.ndarray:
        """Up to ``n`` live stored vectors (host f32), uniformly sampled;
        only the sampled rows leave the device."""
        rng = np.random.default_rng(seed)
        with self._lock:
            locs = list(self._loc_of.values())
            if len(locs) > n:
                sel = rng.choice(len(locs), size=n, replace=False)
                locs = [locs[i] for i in sel]
            la = torch.as_tensor([l for l, _ in locs], dtype=torch.long, device=self.device)
            sa = torch.as_tensor([s for _, s in locs], dtype=torch.long, device=self.device)
            raw = self._storage[la, sa].float().cpu().numpy()
            w = self._valid[la, sa].cpu().numpy()
        return raw * w[:, None]

    def tune_nprobe(self, **kwargs) -> dict:
        """Pick the smallest nprobe meeting a recall target; see
        financial_rag_tpu_torch.index.tuning.tune_nprobe."""
        from financial_rag_tpu_torch.index.tuning import tune_nprobe

        return tune_nprobe(self, **kwargs)

    def storage_devices(self) -> List[torch.device]:
        """The devices that hold the index's tensors (IngestPipeline.flush
        waits on each)."""
        return [self._storage.device]

    # ---------------------------------------------------------- persistence

    def save(self, directory: str | Path) -> None:
        from financial_rag_tpu_torch.index.persist import (
            atomic_savez, atomic_write_json, dtype_name)

        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        with self._lock:
            cents_h = self.centroids.float().cpu().numpy()
            storage_h = self._storage.float().cpu().numpy()
            valid_h = self._valid.cpu().numpy()
            ids_h = self._ids.copy()
            fill_h = self._fill.copy()
        atomic_savez(d / f"{self.name}.npz", centroids=cents_h, storage=storage_h,
                     valid=valid_h, ids=ids_h, fill=fill_h)
        atomic_write_json(d / f"{self.name}.manifest.json", {
            "name": self.name, "dim": self.dim, "nlist": self.nlist,
            "list_size": self.list_size, "nprobe": self.nprobe,
            "count": self.count(), "dtype": dtype_name(self.dtype),
        })

    @classmethod
    def load(cls, directory: str | Path, name: str = "children_ivf", **kwargs) -> "IVFIndex":
        from financial_rag_tpu_torch.index.persist import (
            STR_TO_DTYPE, decode_payload, encode_payload)

        d = Path(directory)
        manifest = json.loads((d / f"{name}.manifest.json").read_text())
        data = np.load(d / f"{name}.npz")
        saved_dtype = manifest.get("dtype")
        if "dtype" not in kwargs and saved_dtype in STR_TO_DTYPE:
            kwargs["dtype"] = STR_TO_DTYPE[saved_dtype]
        idx = cls(dim=manifest["dim"], nlist=manifest["nlist"],
                  list_size=manifest["list_size"], nprobe=manifest["nprobe"],
                  name=name, **kwargs)
        dev = idx.device
        idx.centroids = torch.from_numpy(np.asarray(data["centroids"], np.float32)).to(dev)
        storage, valid = data["storage"], data["valid"]
        if STR_TO_DTYPE.get(saved_dtype, torch.bfloat16) == idx.dtype:
            # same dtype: raw payload + weights reload verbatim
            idx._storage = torch.from_numpy(storage).to(device=dev, dtype=idx.dtype)
            idx._valid = torch.from_numpy(np.asarray(valid, np.float32)).to(dev)
        else:
            # dtype changed between save and load: decode the raw payload to
            # unit-vector space by its saved weights and re-encode; empty
            # slots keep weight 0 (the encode of a zero row would mark it live)
            nl, ls, dim = storage.shape
            w2d = valid.reshape(nl * ls)
            unit = decode_payload(storage.reshape(nl * ls, dim), saved_dtype, weights=w2d)
            payload, weights = encode_payload(unit, idx.dtype, dev)
            idx._storage = payload.reshape(nl, ls, dim)
            idx._valid = torch.from_numpy(
                np.where(w2d > 0, weights, 0.0).astype(np.float32).reshape(nl, ls)).to(dev)
        idx._ids = data["ids"]
        idx._fill = data["fill"]
        idx._loc_of = {
            int(idx._ids[li, sl]): (int(li), int(sl))
            for li, sl in zip(*np.nonzero(valid > 0))
        }
        # rebuild per-list free lists: tombstoned slots below the
        # high-water mark (valid == 0, slot < fill) are reusable
        for li, sl in zip(*np.nonzero(valid <= 0)):
            if sl < idx._fill[li]:
                idx._free.setdefault(int(li), []).append(int(sl))
        return idx
