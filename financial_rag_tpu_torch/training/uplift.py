"""Measure whether contrastive fine-tuning improves retrieval.

Counterpart of financial_rag_tpu/training/uplift.py: fine-tune a randomly
initialized encoder on a task with learnable non-lexical structure
(training/data.synthetic_paraphrase_task) and report held-out recall@k
before and after, evaluated through the port's serving path (Encoder
forward -> FlatIndex exact sweep), on one device or on a mesh (every rank
trains its part of each step and evaluates the gathered parameters).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.checkpoint import random_params
from financial_rag_tpu_torch.models.encoder import Encoder
from financial_rag_tpu_torch.tokenizer import WordPieceTokenizer
from financial_rag_tpu_torch.training.contrastive import adamw, gather_params, make_train_step
from financial_rag_tpu_torch.training.data import PairBatcher, synthetic_paraphrase_task
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("training.uplift")


def eval_recall_at_k(config: ModelConfig, params, tokenizer, eval_pairs,
                     *, k: int = 10, seq_len: int = 64,
                     compute_dtype=None, device=None) -> float:
    """recall@k of query i finding document i, through the serving path:
    the batched Encoder forward feeding a float32 FlatIndex sweep."""
    from financial_rag_tpu_torch.index.flat import FlatIndex

    enc = Encoder(config, params, tokenizer, pooling="mean", max_seq_len=seq_len,
                  compute_dtype=compute_dtype, device=device)
    d_vecs = enc.encode([d for _, d in eval_pairs])
    q_vecs = enc.encode([q for q, _ in eval_pairs])
    idx = FlatIndex(dim=config.hidden_size, capacity=max(len(eval_pairs), 1024),
                    dtype=torch.float32, name="uplift_eval", device=enc.device)
    idx.upsert(np.arange(1, len(eval_pairs) + 1, dtype=np.int64), d_vecs)
    k = min(k, len(eval_pairs))
    ids, _ = idx.search(q_vecs, k)
    hits = sum(1 for i, row in enumerate(ids) if (i + 1) in row.tolist())
    return hits / len(eval_pairs)


def measure_retrieval_uplift(
    config: ModelConfig,
    mesh=None,
    *,
    device=None,
    steps: int = 200,
    batch_size: int = 64,
    lr: float = 3e-4,
    seq_len: int = 32,
    k: int = 10,
    seed: int = 0,
    n_concepts: int = 64,
    n_train: int = 2048,
    n_eval: int = 256,
    compute_dtype=None,
    tokenizer: Optional[WordPieceTokenizer] = None,
) -> dict:
    """Fine-tune a randomly-initialized encoder on the synthetic paraphrase
    task and report held-out recall@k before/after. Returns a JSON-ready
    report dict."""
    device = resolve_device(device)
    tokenizer = tokenizer or WordPieceTokenizer()
    task = synthetic_paraphrase_task(
        tokenizer, n_concepts=n_concepts, n_train=n_train, n_eval=n_eval,
        seed=seed)
    if batch_size > len(task["train_pairs"]):
        # drop_remainder=True would yield ZERO batches per epoch and the
        # step loop below would spin forever waiting for `it` to advance
        raise ValueError(
            f"batch_size {batch_size} exceeds the {len(task['train_pairs'])} "
            f"training pairs — no full batch can form")
    params = random_params(config, seed=seed)

    before = eval_recall_at_k(config, params, tokenizer, task["eval_pairs"], k=k,
                              seq_len=seq_len, compute_dtype=compute_dtype, device=device)
    log.info("recall@%d before fine-tuning: %.4f (chance ~= %.4f)",
             k, before, k / n_eval)

    step, init_state = make_train_step(config, mesh, device=device, optimizer=adamw(lr),
                                       compute_dtype=compute_dtype)
    params, opt_state = init_state(params)
    batcher = PairBatcher(tokenizer, max_seq_len=seq_len)

    loss = None
    it = 0
    epoch = 0
    while it < steps:
        for batch in batcher.batches(task["train_pairs"], batch_size,
                                     shuffle_seed=seed + epoch,
                                     drop_remainder=True):
            params, opt_state, loss = step(params, opt_state, batch)
            it += 1
            if it >= steps:
                break
        epoch += 1
    last_loss = float(loss) if loss is not None else None

    params = gather_params(params, mesh)
    after = eval_recall_at_k(config, params, tokenizer, task["eval_pairs"], k=k,
                             seq_len=seq_len, compute_dtype=compute_dtype, device=device)
    log.info("recall@%d after %d steps: %.4f (was %.4f)", k, it, after, before)
    return {
        "task": ("synthetic paraphrase (disjoint surface vocabularies, "
                 "held-out concept combinations)"),
        "model": f"{config.num_layers}L h{config.hidden_size}",
        "device": str(device),
        "mesh": dict(mesh.shape) if mesh is not None else {"data": 1, "model": 1},
        "attention": step.attention_impl,
        "steps": it,
        "batch_pairs": batch_size,
        "lr": lr,
        "k": k,
        "n_eval": n_eval,
        "chance_recall": round(k / n_eval, 4),
        "recall_before": round(before, 4),
        "recall_after": round(after, 4),
        "uplift": round(after - before, 4),
        "final_loss": round(last_loss, 4),
    }
