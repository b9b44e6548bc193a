"""Reranker fine-tuning on the GPUs: the synthetic uplift measure, or
fine-tuning on mined user feedback.

    python -m financial_rag_tpu_torch.scripts.train_rerank [--steps 300]
    python -m financial_rag_tpu_torch.scripts.train_rerank --feedback-db feedback.db \\
        [--model-path DIR] --out-dir DIR

- default (synthetic uplift measure): fine-tune a randomly initialized
  cross-encoder at the MiniLM-L-6 shape (6 layers, hidden 384) with the
  listwise loss on the zero-lexical-overlap task and report held-out
  rank-1 accuracy before and after through the serving scorer
  (retrieval/rerank.CrossEncoderModel.predict).
- ``--feedback-db PATH``: mine (query, passage, label) triples from rated
  feedback joined with the engine's result cache, fine-tune the checkpoint
  at ``--model-path`` (or a seeded random one) on them, and write a
  checkpoint directory (config.json + model.npz, the JAX package's format)
  to ``--out-dir``, which CROSS_ENCODER_PATH loads in either package. The
  checkpoint keeps its own shape: a bge-base-width cross-encoder (hidden
  768, 12 heads of 64) trains on the GPU as the MiniLM width does (K2 and
  K10 take heads of 32 and of 64).

bf16 compute with float32 master weights on the GPU, data-parallel over
every visible GPU (one rank each, a (n_gpus, 1) mesh, as the JAX script's;
``--batch`` is the global batch); f32 with ``--device cpu``. Prints one
JSON line; ``--out FILE`` also appends it to FILE.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.parallel import launch, train_mesh
from financial_rag_tpu_torch.training.contrastive import adamw
from financial_rag_tpu_torch.training.rerank_ft import (
    ListwiseBatcher,
    make_rerank_train_step,
    measure_rerank_uplift,
    mine_feedback_triples,
    save_finetuned,
    triples_to_groups,
)


def finetune_from_feedback(args, cfg, device, mesh=None) -> dict:
    from financial_rag_tpu_torch.models.checkpoint import load_params, random_params
    from financial_rag_tpu_torch.store.feedback_db import FeedbackDatabase

    triples = mine_feedback_triples(FeedbackDatabase(args.feedback_db))
    groups = triples_to_groups(triples, group_size=args.group, seed=0)
    if not groups:
        return {"error": "no rated feedback with cached results to mine"}
    if args.model_path:
        params, cfg = load_params(args.model_path, fallback_seed=0)
    else:
        params = random_params(cfg, seed=0)
    step, init_state = make_rerank_train_step(cfg, mesh, device=device, optimizer=adamw(args.lr))
    params, opt_state = init_state(params)
    batcher = ListwiseBatcher(max_seq_len=args.seq)
    losses, done, epoch = [], 0, 0
    while done < args.steps:
        for batch in batcher.batches(groups, min(args.batch, len(groups)), shuffle_seed=epoch):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
            done += 1
            if done >= args.steps:
                break
        epoch += 1
    out = save_finetuned(params, cfg, args.out_dir, mesh)
    return {"mode": "feedback", "triples": len(triples), "groups": len(groups), "steps": done,
            "loss_first": losses[0], "loss_last": losses[-1], "checkpoint": str(out),
            "device": str(device)}


def run(args, device, mesh=None) -> dict:
    cfg = ModelConfig(name="minilm-ce-shape", hidden_size=args.hidden, num_layers=args.layers,
                      num_heads=max(args.hidden // 32, 4), intermediate_size=args.hidden * 4,
                      vocab_size=30522, max_position=512, num_labels=1)
    if args.feedback_db:
        return finetune_from_feedback(args, cfg, device, mesh)
    rep, _ = measure_rerank_uplift(
        cfg, mesh, device=device, steps=args.steps, batch_size=args.batch,
        group_size=args.group, lr=args.lr, seq_len=args.seq, n_concepts=args.concepts,
        n_train=args.train, n_eval=args.eval)
    return {
        "metric": (f"held-out rank-1 accuracy uplift from listwise reranker fine-tuning "
                   f"({args.layers}L random init, {args.steps} steps, group={args.group})"),
        "value": rep["rank1_after"] - rep["rank1_before"], "unit": "rank1_accuracy",
        **rep,
    }


def run_rank(rank: int, world: int, device, args) -> dict:
    return run(args, device, train_mesh(1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--concepts", type=int, default=64)
    ap.add_argument("--train", type=int, default=1024)
    ap.add_argument("--eval", type=int, default=192)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--feedback-db", default=None,
                    help="fine-tune on mined user feedback instead of the synthetic measure")
    ap.add_argument("--model-path", default=None,
                    help="checkpoint dir to start from (feedback mode)")
    ap.add_argument("--out-dir", default="rerank_finetuned",
                    help="checkpoint dir to write (feedback mode)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    t0 = time.time()
    world = launch.data_parallel_world(device)
    rep = (launch.spawn(run_rank, world, args=(args,), device=device)[0] if world > 1
           else run(args, device))
    rep["device_name"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rep["wall_s"] = time.time() - t0
    line = json.dumps(rep)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 1 if "error" in rep else 0


if __name__ == "__main__":
    raise SystemExit(main())
