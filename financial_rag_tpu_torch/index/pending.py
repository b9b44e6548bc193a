"""Dispatch/materialize split for index searches.

Counterpart of financial_rag_tpu/index/pending.py. A search launches its
device work and returns a :class:`SearchPending`; ``collect`` materializes
any number of pendings (and optional extra device tensors) with ONE
synchronising device-to-host copy: every 4-byte CUDA tensor is viewed as
int32, concatenated on the device, copied once, and split back on the host.

    p1 = index_a.search_begin(q, k)       # launch only
    p2 = index_b.search_begin(q, k)
    (ids_a, sc_a), (ids_b, sc_b) = collect([p1, p2])
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def _leaves(tree, out: List[torch.Tensor]):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)


def _rebuild(tree, it):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    if isinstance(tree, torch.Tensor):
        return next(it)
    return tree


def device_get(tree):
    """Nested lists/tuples of tensors -> the same structure of numpy arrays,
    with one device-to-host copy for all CUDA tensors of 4-byte dtypes."""
    leaves: List[torch.Tensor] = []
    _leaves(tree, leaves)
    packable = [t for t in leaves if t.is_cuda and t.element_size() == 4]
    host = {}
    if packable:
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.int32)
                          for t in packable]).cpu()
        off = 0
        for t in packable:
            n = t.numel()
            host[id(t)] = flat[off:off + n].view(t.dtype).reshape(t.shape).numpy()
            off += n
    arrays = [host[id(t)] if id(t) in host else t.detach().cpu().numpy() for t in leaves]
    return _rebuild(tree, iter(arrays))


class SearchPending:
    """A dispatched index search: ``refs`` is a nested tuple of device
    tensors (or None for trivial/empty cases), ``finish`` maps the fetched
    host arrays to the final ``(ids, scores)``."""

    __slots__ = ("refs", "finish")

    def __init__(self, refs, finish: Callable):
        self.refs = refs
        self.finish = finish

    def get(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.finish(device_get(self.refs))


def ready(ids: np.ndarray, scores: np.ndarray) -> SearchPending:
    """A pending whose result is already on the host (empty index, ...)."""
    return SearchPending(None, lambda _: (ids, scores))


def collect(pendings: Sequence[SearchPending], extra=None):
    """Materialize many pendings with ONE device-to-host copy. ``extra``:
    optional list of device tensors fetched in the SAME copy (e.g. query
    embeddings for the host-side cache); then returns (results, extra_host)."""
    if extra is None:
        host = device_get([p.refs for p in pendings])
        return [p.finish(h) for p, h in zip(pendings, host)]
    host, extra_host = device_get(([p.refs for p in pendings], list(extra)))
    return [p.finish(h) for p, h in zip(pendings, host)], extra_host
