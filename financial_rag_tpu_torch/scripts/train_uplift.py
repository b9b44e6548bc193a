"""Training -> retrieval uplift on the GPUs.

    python -m financial_rag_tpu_torch.scripts.train_uplift [--steps 200] [--batch 256]

Fine-tunes a randomly initialized encoder at the bge-small shape (12
layers, hidden 384) on the synthetic paraphrase task (disjoint surface
vocabularies for shared latent concepts, so lexical matching scores at
chance and only a learned query/document alignment retrieves) and reports
held-out recall@k before and after, evaluated through the port's serving
path (Encoder forward -> FlatIndex sweep). bf16 compute with float32
master weights on the GPU, data-parallel over every visible GPU (one rank
each, a (n_gpus, 1) mesh, as the JAX script's; ``--batch`` is the global
batch); f32 with ``--device cpu``. Prints one JSON line; ``--out FILE``
also appends it to FILE.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.parallel import launch, train_mesh
from financial_rag_tpu_torch.training.uplift import measure_retrieval_uplift


def run(args, device, mesh=None) -> dict:
    cfg = ModelConfig(name="bge-small-shape", hidden_size=args.hidden, num_layers=args.layers,
                      num_heads=max(args.hidden // 32, 4), intermediate_size=args.hidden * 4,
                      vocab_size=30522, max_position=512)
    return measure_retrieval_uplift(
        cfg, mesh, device=device, steps=args.steps, batch_size=args.batch, lr=args.lr,
        seq_len=args.seq, k=args.k, n_concepts=args.concepts, n_train=args.train,
        n_eval=args.eval)


def run_rank(rank: int, world: int, device, args) -> dict:
    return run(args, device, train_mesh(1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--concepts", type=int, default=64)
    ap.add_argument("--train", type=int, default=2048)
    ap.add_argument("--eval", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    t0 = time.time()
    world = launch.data_parallel_world(device)
    rep = (launch.spawn(run_rank, world, args=(args,), device=device)[0] if world > 1
           else run(args, device))
    rep = {
        "metric": (f"held-out recall@{args.k} uplift from contrastive fine-tuning "
                   f"({args.layers}L random init, {args.steps} steps)"),
        "value": rep["uplift"], "unit": "recall",
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "wall_s": time.time() - t0,
        **rep,
    }
    line = json.dumps(rep)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
