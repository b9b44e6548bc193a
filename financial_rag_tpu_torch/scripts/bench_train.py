"""Contrastive train-step throughput on the GPUs.

    python -m financial_rag_tpu_torch.scripts.bench_train [--device cpu] [--out FILE]

Runs training/contrastive.make_train_step at the bge-small shape (12
layers, hidden 384, 12 heads, FFN 1,536, vocab 30,522) with float32 master
weights on seeded random ids: 256 pairs x 128 tokens per GPU in bf16, the
JAX package's size, data-parallel over every visible GPU (one rank each,
a (n_gpus, 1) mesh, as the JAX bench's); on the CPU, 2 layers at 8 x 32 in
f32, one process. Times
each of 10 steps after 3 warm-up steps with CUDA events (the step ends in
the optimizer's update, so the events bracket the whole step on the
device). Prints one JSON line: the median step time, pairs per second,
the peak device memory and the device's name. ``--device cpu`` times on
the host clock instead and says so; ``--out FILE`` also appends the line
to FILE.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, List

import numpy as np
import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.checkpoint import random_params
from financial_rag_tpu_torch.parallel import launch, train_mesh
from financial_rag_tpu_torch.training.contrastive import make_train_step

WARMUP_STEPS, TIMED_STEPS = 3, 10


def bge_small_config(layers: int = 12, **kw) -> ModelConfig:
    return ModelConfig(name="bge-small-shape", hidden_size=384, num_layers=layers,
                       num_heads=12, intermediate_size=1536, vocab_size=30522,
                       max_position=512, **kw)


def bge_base_config(layers: int = 12, **kw) -> ModelConfig:
    """The bge-base-en-v1.5 / gte-base shape: 12 heads of 64, FFN 3,072."""
    return ModelConfig(name="bge-base-shape", hidden_size=768, num_layers=layers,
                       num_heads=12, intermediate_size=3072, vocab_size=30522,
                       max_position=512, **kw)


def random_pair_batch(batch: int, seq: int, seed: int = 0, vocab: int = 30000) -> dict:
    """Seeded random ids, every position real (the JAX bench's batch)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.integers(5, vocab, size=(batch, seq)).astype(np.int32) if k.endswith("ids")
                else np.ones((batch, seq), np.int32))
            for k in ("q_ids", "q_mask", "d_ids", "d_mask")}


def time_steps(run: Callable[[], object], device: torch.device, *, warmup: int,
               steps: int) -> List[float]:
    """Milliseconds of each of ``steps`` calls of ``run`` after ``warmup``
    calls: CUDA events on a GPU, the host clock (after the call) on the
    CPU."""
    for _ in range(warmup):
        run()
    if device.type != "cuda":
        out = []
        for _ in range(steps):
            t0 = time.perf_counter()
            run()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    torch.cuda.synchronize(device)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    for start, end in events:
        start.record()
        run()
        end.record()
    torch.cuda.synchronize(device)
    return [start.elapsed_time(end) for start, end in events]


def run(device: torch.device, mesh=None) -> dict:
    world = 1 if mesh is None else mesh.world
    B, S, layers = (256 * world, 128, 12) if device.type == "cuda" else (8, 32, 2)
    cfg = bge_small_config(layers)
    step, init_state = make_train_step(cfg, mesh, device=device)
    params, opt_state = init_state(random_params(cfg, seed=0))
    batch = {k: torch.from_numpy(v).to(device) for k, v in random_pair_batch(B, S).items()}
    losses = []

    def run_step():
        _, _, loss = step(params, opt_state, batch)
        losses.append(loss)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ms = time_steps(run_step, device, warmup=WARMUP_STEPS, steps=TIMED_STEPS)
    per_step = statistics.median(ms)
    return {
        "metric": (f"contrastive train step ({B}x2x{S} pairs, "
                   f"{cfg.num_layers}L {str(step.compute_dtype).replace('torch.', '')}, "
                   + ("K2/K10 attention, K3 FFN)" if device.type == "cuda"
                      else "plain attention and FFN)")),
        "value": per_step, "unit": "ms",
        "pairs_per_s": B / per_step * 1e3,
        "step_ms": ms,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ranks": world,
        "timer": "cuda events" if device.type == "cuda" else "host clock",
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }


def run_rank(rank: int, world: int, device: torch.device) -> dict:
    return run(device, train_mesh(1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    world = launch.data_parallel_world(device)
    rep = launch.spawn(run_rank, world, device=device)[0] if world > 1 else run(device)
    line = json.dumps(rep)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
