"""Start one process per rank and join them.

The JAX package drives every device from one controller; the port runs one
process per rank. :func:`spawn` starts ``world`` ranks with
``torch.multiprocessing`` and the ``spawn`` start method (never ``fork``
with CUDA), joins them through a ``FileStore`` in a fresh temporary
directory (no port to pick, so concurrent launches never collide) and
returns each rank's return value, in rank order. A rank calls
``fn(rank, world, device, *args)`` inside an initialised default group
whose collectives time out after ``timeout_s`` (a mesh's groups take
theirs from ``make_mesh(..., timeout_s=)``); if any rank raises, the
others are stopped and :func:`spawn` raises with every failed rank's
traceback, the earliest first, and the whole launch is stopped after
``join_timeout_s``.

The backend is chosen explicitly and logged:

- ``nccl``, one GPU per rank (``cuda:rank``), when ``device_count() >= world``;
- ``gloo`` with the ranks sharing the GPUs (rank r on ``cuda:r %
  device_count()``) when there are fewer GPUs than ranks (NCCL refuses two
  ranks on one device). gloo stages CUDA tensors through the host;
- ``gloo`` on the CPU.

The CUDA kernel library is built by the parent before any rank starts;
the ranks only load it, so no two ``nvcc`` builds race into one directory.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("parallel.launch")


def choose_backend(world: int, device_type: str) -> Tuple[str, int]:
    """(backend, number of GPUs the ranks are spread over; 0 on the CPU)."""
    if device_type != "cuda":
        return "gloo", 0
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("CUDA ranks requested but no CUDA device is visible")
    return ("nccl", world) if n >= world else ("gloo", n)


def data_parallel_world(device: torch.device) -> int:
    """The entry points' data-parallel world: every visible GPU (the JAX
    scripts' (n_devices, 1) mesh), one rank on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def rank_device(rank: int, device_type: str, n_gpus: int) -> torch.device:
    return torch.device("cuda", rank % n_gpus) if device_type == "cuda" else torch.device("cpu")


def _rank_main(rank: int, fn, world: int, device_type: str, backend: str, n_gpus: int,
               store: str, timeout_s: float, out_dir: str, threads: int, args: tuple):
    device = rank_device(rank, device_type, n_gpus)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, device, *args)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    except BaseException:
        # the time first: the parent reports the earliest failure first (the
        # others are usually ranks whose collective lost this one)
        (Path(out_dir) / f"rank{rank}.err").write_text(
            f"{time.time()!r}\n-- rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world: int, *, args: tuple = (), device=None,
          timeout_s: float = 60.0, join_timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes and
    return their return values in rank order (read back with
    ``torch.load(map_location="cpu")``: return CPU tensors or plain data).
    ``fn`` must be importable by name (a module-level function)."""
    dev = resolve_device(device)
    chosen, n_gpus = choose_backend(world, dev.type)
    log.info("spawn: %d ranks, backend %s, device %s%s", world, chosen, dev.type,
             f" over {n_gpus} GPU(s)" if dev.type == "cuda" else "")
    if dev.type == "cuda":
        from financial_rag_tpu_torch.ops import kernel_lib

        kernel_lib.build()
    threads = max(1, (os.cpu_count() or 1) // world)
    tmp = tempfile.mkdtemp(prefix="frag_spawn_")
    try:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, dev.type, chosen, n_gpus, store, timeout_s, tmp,
                              threads, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world} ranks still running after "
                                       f"{join_timeout_s} s")
        except BaseException as exc:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
            errs = sorted((float(t), text) for t, text in (
                f.read_text().split("\n", 1) for f in Path(tmp).glob("rank*.err")))
            if errs:
                raise RuntimeError("spawn: a rank raised; the tracebacks, earliest first:\n"
                                   + "\n".join(text for _, text in errs)) from exc
            raise
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
