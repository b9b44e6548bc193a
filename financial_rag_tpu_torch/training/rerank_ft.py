"""Cross-encoder (reranker) fine-tuning on one GPU or a mesh.

Counterpart of financial_rag_tpu/training/rerank_ft.py. (query, passage,
label) triples are mined from the feedback DB (ratings joined with the md5
result cache that holds each query's retrieved chunks) and the
cross-encoder fine-tunes on them with a listwise softmax loss. The mining,
grouping and batching are host code, copied. The train step is the
contrastive step's (training/contrastive.py): float32 master weights, bf16
compute on the GPU through K2/K10 and K3, the optimizer updating the
parameter tensors in place. On a (data, model) mesh it shards as the
contrastive step does (K11 under a model axis), but the listwise loss is a
mean over each data rank's own groups, so the data axis AVERAGES the
ranks' gradients and losses. The uplift harness evaluates held-out
rank-1 accuracy through the serving scorer
(``retrieval/rerank.CrossEncoderModel.predict``) before and after, and
``save_finetuned`` writes a checkpoint in the JAX package's format, so
either package loads what the other wrote.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.bert import cross_encoder_forward
from financial_rag_tpu_torch.tokenizer import WordPieceTokenizer
from financial_rag_tpu_torch.training.contrastive import (
    OptimizerFactory,
    adamw,
    check_train_widths,
    gather_params,
    make_step,
    resolve_compute_dtype,
    tp_arg,
)
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("training.rerank_ft")

Triple = Tuple[str, str, int]  # (query, passage, label in {0, 1})


# --------------------------------------------------------------- mining


def mine_feedback_triples(
    feedback_db,
    *,
    min_pos_rating: int = 4,
    max_neg_rating: int = 2,
    per_query: int = 3,
    window_s: Optional[float] = None,
) -> List[Triple]:
    """(query, passage, label) triples from user feedback.

    A rating >= min_pos_rating marks the query's top retrieved passages as
    positives (the user said the answer built on them was good); a rating
    <= max_neg_rating marks them HARD negatives (retrieval looked
    confident, the user said the answer was wrong — exactly the pairs a
    reranker must learn to demote). Mid-range ratings carry no signal and
    are skipped. Passages come from the result cache the engine already
    maintains (store/feedback_db.py query_cache), so mining needs no new
    write path on the serving side.
    """
    out: List[Triple] = []
    seen = set()
    for query, rating, result in feedback_db.rated_results(window_s=window_s):
        if rating is None:
            continue
        if rating >= min_pos_rating:
            label = 1
        elif rating <= max_neg_rating:
            label = 0
        else:
            continue
        chunks = result.get("top_children_chunks") or result.get("chunks") or []
        for c in chunks[:per_query]:
            text = (c or {}).get("text")
            if not text:
                continue
            key = (query, text)
            if key in seen:
                continue
            seen.add(key)
            out.append((query, text, label))
    return out


def triples_to_groups(
    triples: Sequence[Triple],
    *,
    group_size: int = 4,
    seed: int = 0,
) -> List[Tuple[str, List[str]]]:
    """Listwise groups: (query, [positive, neg_1, ... neg_{G-1}]).

    Negatives for a query are its own hard negatives first (label-0
    passages the user down-rated), then random passages from OTHER queries
    (in-batch-style negatives). Queries with no positive passage
    contribute only their hard negatives to other groups.
    """
    rng = np.random.default_rng(seed)
    by_query: dict = {}
    all_passages: List[str] = []
    for q, text, label in triples:
        by_query.setdefault(q, {"pos": [], "neg": []})["pos" if label else "neg"].append(text)
        all_passages.append(text)
    if not all_passages:
        return []
    groups: List[Tuple[str, List[str]]] = []
    for q, sides in by_query.items():
        for pos in sides["pos"]:
            negs = [t for t in sides["neg"] if t != pos][: group_size - 1]
            while len(negs) < group_size - 1:
                cand = all_passages[int(rng.integers(len(all_passages)))]
                if cand != pos and cand not in negs:
                    negs.append(cand)
            groups.append((q, [pos] + negs))
    return groups


# --------------------------------------------------------------- batching


class ListwiseBatcher:
    """Tokenizes (query, [cand_0..cand_{G-1}]) groups into static
    [B, G, S] pair tensors; candidate 0 is the positive (the loss label)."""

    def __init__(self, tokenizer: Optional[WordPieceTokenizer] = None,
                 max_seq_len: int = 128) -> None:
        self.tokenizer = tokenizer or WordPieceTokenizer()
        self.max_seq_len = max_seq_len

    def _encode_group(self, query: str, cands: Sequence[str]):
        S = self.max_seq_len
        ids = np.full((len(cands), S), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((len(cands), S), np.int32)
        types = np.zeros((len(cands), S), np.int32)
        for r, text in enumerate(cands):
            seq, tt = self.tokenizer.encode_pair(query, text, max_len=S)
            ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = 1
            types[r, : len(tt)] = tt
        return ids, mask, types

    def batches(self, groups: Sequence[Tuple[str, Sequence[str]]],
                batch_size: int, *, shuffle_seed: Optional[int] = 0,
                drop_remainder: bool = True) -> Iterator[dict]:
        """Yields {ids, mask, types} of static shape [B, G, S]. Groups in a
        short final batch are padded by repeating earlier groups (their
        gradient contribution is real but harmless — same loss surface)."""
        if not groups:
            return
        order = np.arange(len(groups))
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(order)
        G = len(groups[0][1])
        for lo in range(0, len(order), batch_size):
            sel = order[lo: lo + batch_size].tolist()
            if len(sel) < batch_size:
                if drop_remainder and lo:
                    return
                # only/last short batch: repeat-pad by cycling its own
                # groups so the [B, G, S] shape stays static
                n = len(sel)
                sel = [sel[i % n] for i in range(batch_size)]
            ids = np.empty((batch_size, G, self.max_seq_len), np.int32)
            mask = np.empty_like(ids)
            types = np.empty_like(ids)
            for b, gi in enumerate(sel):
                q, cands = groups[gi]
                ids[b], mask[b], types[b] = self._encode_group(q, cands)
            yield {"ids": ids, "mask": mask, "types": types}


# --------------------------------------------------------------- training


def listwise_loss(logits: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy over each group's G logits ([B, G]), candidate
    0 the positive, averaged over the B groups."""
    labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    return F.cross_entropy(logits.float(), labels)


def make_rerank_train_step(
    config: ModelConfig,
    mesh=None,
    *,
    device=None,
    optimizer: Optional[OptimizerFactory] = None,
    compute_dtype: Optional[torch.dtype] = None,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Returns (train_step, init_state) for listwise cross-encoder tuning.

    Batch dict: ids/mask/types, all [B, G, S] int with candidate 0 the
    positive. The [B, G] group dim flattens into one [B*G, S] forward (the
    serving scorer's kernels and shapes) and the loss is softmax
    cross-entropy over each group's G logits. The default optimizer,
    ``adamw(2e-5)``, is ``optax.adamw(2e-5)``. ``mesh`` as for
    contrastive.make_train_step (B divisible by the data axis's size).
    """
    device = resolve_device(device)
    tp = tp_arg(config, mesh, model_axis)
    check_train_widths(config, device, tp)
    dt = resolve_compute_dtype(device, compute_dtype)

    def loss_fn(params, batch):
        b, g, s = batch["ids"].shape
        logits = cross_encoder_forward(
            params, batch["ids"].reshape(b * g, s), batch["mask"].reshape(b * g, s),
            batch["types"].reshape(b * g, s), config=config, compute_dtype=dt, tp=tp,
        ).reshape(b, g)
        return listwise_loss(logits)

    return make_step(loss_fn, device, optimizer or adamw(2e-5), dt, mesh=mesh,
                     data_axis=data_axis, model_axis=model_axis, grad_reduce="mean",
                     loss_reduce="mean")


# --------------------------------------------------------------- uplift


def eval_rank1_accuracy(config: ModelConfig, params, tokenizer,
                        eval_groups: Sequence[Tuple[str, Sequence[str]]],
                        *, max_seq_len: int = 64, compute_dtype=None, device=None) -> float:
    """Fraction of held-out groups whose TRUE passage (candidate 0) gets
    the top score, through the serving scorer (CrossEncoderModel.predict)."""
    from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderModel

    model = CrossEncoderModel(config, params, tokenizer, max_seq_len=max_seq_len,
                              compute_dtype=compute_dtype, device=device)
    pairs = [(q, text) for q, cands in eval_groups for text in cands]
    scores = model.predict(pairs)
    hits, at = 0, 0
    for _, cands in eval_groups:
        g = scores[at: at + len(cands)]
        at += len(cands)
        hits += int(np.argmax(g) == 0)
    return hits / max(len(eval_groups), 1)


def groups_from_task(task: dict, split: str, *, group_size: int = 4,
                     seed: int = 0) -> List[Tuple[str, List[str]]]:
    """Listwise groups from training/data.synthetic_paraphrase_task pairs:
    each query's own document is the positive; distractors are other
    documents from the same split (zero lexical overlap with the query, so
    an untrained scorer sits at chance = 1/group_size)."""
    pairs = task[f"{split}_pairs"]
    rng = np.random.default_rng(seed)
    docs = [d for _, d in pairs]
    groups = []
    for i, (q, d) in enumerate(pairs):
        negs: List[str] = []
        while len(negs) < group_size - 1:
            j = int(rng.integers(len(docs)))
            if j != i and docs[j] not in negs:
                negs.append(docs[j])
        groups.append((q, [d] + negs))
    return groups


def measure_rerank_uplift(
    config: ModelConfig,
    mesh=None,
    *,
    device=None,
    steps: int = 150,
    batch_size: int = 32,
    group_size: int = 4,
    lr: float = 3e-4,
    seq_len: int = 32,
    seed: int = 0,
    n_concepts: int = 64,
    n_train: int = 1024,
    n_eval: int = 128,
    compute_dtype=None,
    tokenizer: Optional[WordPieceTokenizer] = None,
):
    """Fine-tune a randomly-initialized cross-encoder on the synthetic
    zero-lexical-overlap task and report held-out rank-1 accuracy
    before/after through the serving scorer. Returns (json-ready report
    dict, fine-tuned params)."""
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.training.data import synthetic_paraphrase_task

    device = resolve_device(device)
    tokenizer = tokenizer or WordPieceTokenizer()
    if config.num_labels < 1:
        raise ValueError("cross-encoder config needs num_labels >= 1")
    task = synthetic_paraphrase_task(tokenizer, n_concepts=n_concepts,
                                     n_train=n_train, n_eval=n_eval, seed=seed)
    train_groups = groups_from_task(task, "train", group_size=group_size, seed=seed)
    eval_groups = groups_from_task(task, "eval", group_size=group_size, seed=seed + 1)

    params = random_params(config, seed=seed)
    acc_before = eval_rank1_accuracy(config, params, tokenizer, eval_groups,
                                     max_seq_len=seq_len, compute_dtype=compute_dtype,
                                     device=device)

    step, init_state = make_rerank_train_step(config, mesh, device=device, optimizer=adamw(lr),
                                              compute_dtype=compute_dtype)
    params, opt_state = init_state(params)
    batcher = ListwiseBatcher(tokenizer, max_seq_len=seq_len)

    losses: List[float] = []
    done = 0
    epoch = 0
    while done < steps:
        for batch in batcher.batches(train_groups, batch_size,
                                     shuffle_seed=seed + epoch):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
            done += 1
            if done >= steps:
                break
        epoch += 1

    params = gather_params(params, mesh)
    acc_after = eval_rank1_accuracy(config, params, tokenizer, eval_groups,
                                    max_seq_len=seq_len, compute_dtype=compute_dtype,
                                    device=device)
    report = {
        "steps": done,
        "loss_first": round(losses[0], 4) if losses else None,
        "loss_last": round(losses[-1], 4) if losses else None,
        "rank1_before": round(acc_before, 4),
        "rank1_after": round(acc_after, 4),
        "chance": round(1.0 / group_size, 4),
        "group_size": group_size,
        "attention_impl": step.attention_impl,
        "device": str(device),
        "mesh": dict(mesh.shape) if mesh is not None else {"data": 1, "model": 1},
    }
    log.info("rerank uplift: %s", report)
    return report, params


# ------------------------------------------------------------ persistence


def save_finetuned(params, config: ModelConfig, out_dir: str | Path, mesh=None) -> Path:
    """Write a loadable checkpoint dir in the JAX package's format:
    HF-style config.json (so ModelConfig.from_json and
    CrossEncoderModel.from_pretrained resolve the architecture and the
    classification head) and model.npz with the parameter tree. On a mesh
    every rank calls it: the shards are gathered, and rank 0 writes."""
    from financial_rag_tpu_torch.models.checkpoint import save_params_npz

    params = gather_params(params, mesh)
    out = Path(out_dir)
    if mesh is not None and mesh.rank != 0:
        return out
    out.mkdir(parents=True, exist_ok=True)
    cfg = {
        "architectures": ["BertForSequenceClassification"],
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "intermediate_size": config.intermediate_size,
        "vocab_size": config.vocab_size,
        "max_position_embeddings": config.max_position,
        "type_vocab_size": config.type_vocab_size,
        "layer_norm_eps": config.layer_norm_eps,
        "id2label": {str(i): f"LABEL_{i}" for i in range(max(config.num_labels, 1))},
    }
    (out / "config.json").write_text(json.dumps(cfg, indent=1))
    save_params_npz(params, out / "model.npz")
    return out
