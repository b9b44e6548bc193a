"""Process meshes: one process per rank, named axes, one group per axis line.

Counterpart of financial_rag_tpu/parallel/mesh.py. The JAX package lays
devices of one controller out in a ``jax.sharding.Mesh``; the port runs one
process per rank (parallel/launch.py) and lays the ranks out the same way,
``np.arange(world).reshape(sizes)``: on a (data, model) mesh rank
d * tp + m sits at data row d and model column m. A :class:`Mesh` holds
the axis sizes (``mesh.shape["model"]`` reads as in JAX), this rank's
coordinates, and one ``torch.distributed`` group per axis: the ranks that
differ from this one only along that axis. An axis of size 1 has no group
(a collective over it is the identity).

Without a process group (one process, no ``torch.distributed``) every
mesh is 1 x 1 and has no groups: that is the single-GPU path.

Serving needs no collective, so its layouts are plain device lists held by
one process: ``search_devices`` (the counterpart of ``search_mesh``) places
the shards of a sharded index, ``encode_devices`` (of the runtime's
``_encode_mesh``) the replicas of a data-parallel encoder. Where the machine
has fewer GPUs than shards, shard ``i`` goes on ``cuda:(i % count)`` with a
warning (the JAX package clamps to the devices it has); on the CPU every
shard is ``cpu``.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from financial_rag_tpu_torch.device import DeviceLike, resolve_device
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("parallel.mesh")


class Mesh:
    """A named (data, model)-style layout of the ranks of one process group."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], rank: int,
                 groups: Dict[str, object]):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.world = int(np.prod(sizes))
        self.rank = rank
        self.ranks = np.arange(self.world).reshape(tuple(sizes))
        where = np.argwhere(self.ranks == rank)[0]
        self.coords: Dict[str, int] = dict(zip(self.axis_names, (int(c) for c in where)))
        self.groups = groups

    def group(self, axis: str):
        """This rank's group along ``axis``, or None where the axis has size 1."""
        return self.groups.get(axis)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(axes: Sequence[Tuple[str, int]], world: Optional[int] = None,
              timeout_s: Optional[float] = None) -> Mesh:
    """axes: ordered (name, size) pairs whose sizes multiply to the world
    size; one size may be -1, the remainder. Every rank of the default
    group must call it, with the same axes: each group is made by all of
    them (``torch.distributed.new_group``), in the same order.
    ``timeout_s``: the timeout of each group's collectives; None is
    torch.distributed's default for the backend."""
    n, rank = _world()
    world = n if world is None else world
    if world != n:
        raise ValueError(f"mesh over {world} ranks, but the process group has {n}")
    sizes = [s for _, s in axes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may have size -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if world % known:
            raise ValueError(f"{world} ranks not divisible by {known}")
        sizes = [world // known if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {sizes} != {world} ranks")
    names = [name for name, _ in axes]
    ranks = np.arange(world).reshape(sizes)
    timeout = datetime.timedelta(seconds=timeout_s) if timeout_s is not None else None
    groups: Dict[str, object] = {}
    for ax, name in enumerate(names):
        if sizes[ax] == 1:
            continue
        # every line of the mesh along this axis, in the same order on every rank
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, sizes[ax])
        for line in lines:
            members = [int(r) for r in line]
            group = dist.new_group(ranks=members, timeout=timeout)
            if rank in members:
                groups[name] = group
    return Mesh(names, sizes, rank, groups)


def train_mesh(tp: int = 1, world: Optional[int] = None,
               timeout_s: Optional[float] = None) -> Mesh:
    """(data, model) mesh: tensor-parallel size tp, data-parallel remainder."""
    return make_mesh([("data", -1), ("model", tp)], world, timeout_s)


def search_devices(n_shards: int = 0, device: DeviceLike = None) -> List[torch.device]:
    """The devices of an ``n_shards``-way search or encode, in shard order:
    ``devices[:n]`` of the GPUs (all of them for 0), as ``search_mesh``
    takes them. With fewer GPUs than ``n``, shard ``i`` goes on
    ``cuda:(i % count)``, with a warning. On the CPU, ``n`` (1 for 0) times
    ``cpu``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * max(int(n_shards), 1)
    count = torch.cuda.device_count()
    n = int(n_shards) or count
    if n > count:
        log.warning("%d shards on %d GPU(s): shard i goes on cuda:(i %% %d)", n, count, count)
    return [torch.device("cuda", i % count) for i in range(n)]


def encode_devices(encode_dp: int, device: DeviceLike = None) -> Optional[List[torch.device]]:
    """The replicas of a data-parallel encode (``ENCODE_DP``), or None for
    one device: the largest power of two <= ``encode_dp``, as the JAX
    runtime's ``_encode_mesh`` takes it (every batch bucket must split
    evenly), on ``search_devices``' layout."""
    n = int(encode_dp)
    if n <= 1:
        return None
    use = 1
    while use * 2 <= n:
        use *= 2
    if use != n:
        log.warning("ENCODE_DP=%d -> using %d replicas", n, use)
    return search_devices(use, device) if use > 1 else None
