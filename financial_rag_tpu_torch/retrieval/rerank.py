"""Cross-encoder reranking.

Counterpart of financial_rag_tpu/retrieval/rerank.py: the MiniLM-L-6
sequence-classification model scores (query, chunk) pairs in one batched
forward on the device (through the same attention and FFN kernels as the
encoders), then scores get the reference's adaptive normalization and the
0.8·cross + 0.2·retrieval blend. Also reproduces: the "Aggregation" strategy
skip, the retrieval-score-sort fallback when no model is available, the
uniform-score fallback when prediction fails, and the load-time sanity
self-test that detects non-discriminating or inverted scoring.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from financial_rag_tpu_torch.config import ModelConfig, RerankConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.bert import cross_encoder_forward, prepare_params
from financial_rag_tpu_torch.models.checkpoint import load_params
from financial_rag_tpu_torch.models.encoder import default_compute_dtype
from financial_rag_tpu_torch.tokenizer import WordPieceTokenizer
from financial_rag_tpu_torch.utils import get_logger, time_block

log = get_logger("retrieval.rerank")

PAIR_BUCKETS = (8, 16, 32, 64, 128)
SEQ_BUCKETS = (128, 256, 512)


class CrossEncoderModel:
    """Batched (query, text) -> relevance logit scorer."""

    def __init__(self, config: ModelConfig, params,
                 tokenizer: Optional[WordPieceTokenizer] = None,
                 max_seq_len: int = 512, compute_dtype: Optional[torch.dtype] = None,
                 device=None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        self.params = prepare_params(params, device=self.device,
                                     compute_dtype=self.compute_dtype)
        self.tokenizer = tokenizer or WordPieceTokenizer()
        self.max_seq_len = max_seq_len

    @classmethod
    def from_pretrained(cls, model_dir: str, *, fallback_seed: Optional[int] = None, **kw):
        params, config = load_params(model_dir, fallback_seed=fallback_seed)
        if "classifier" not in params:
            raise ValueError(f"{model_dir} has no classification head")
        return cls(config, params, **kw)

    def pair_inputs(self, pairs: Sequence[Sequence[str]], *,
                    pad_pairs: Optional[int] = None) -> tuple:
        """(ids, mask, types) int32 [rows, seq_len] of ``pairs`` (non-empty),
        padded to a pair bucket (``pad_pairs`` pins the row count) and a
        sequence bucket; padding rows attend their first position only."""
        enc = [self.tokenizer.encode_pair(a, b, max_len=self.max_seq_len) for a, b in pairs]
        longest = max(len(ids) for ids, _ in enc)
        # cap buckets at max_seq_len: a small model (max_position < 128)
        # must never be padded past its own position table
        seq_len = next((s for s in SEQ_BUCKETS if longest <= s <= self.max_seq_len),
                       self.max_seq_len)
        n = len(enc)
        if pad_pairs is not None and pad_pairs >= n:
            npad = pad_pairs
        else:
            npad = next((p for p in PAIR_BUCKETS if n <= p), ((n + 127) // 128) * 128)

        ids = np.full((npad, seq_len), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((npad, seq_len), np.int32)
        types = np.zeros((npad, seq_len), np.int32)
        for r, (seq, tt) in enumerate(enc):
            seq, tt = seq[:seq_len], tt[:seq_len]
            ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = 1
            types[r, : len(tt)] = tt
        mask[n:, 0] = 1
        return ids, mask, types

    def predict_begin(self, pairs: Sequence[Sequence[str]], *,
                      pad_pairs: Optional[int] = None):
        """Launch-only scoring: run the device forward, return a zero-arg
        materializer producing [N] float32 logits. ``pad_pairs`` pins the
        row count to one shape."""
        if not len(pairs):
            return lambda: np.zeros((0,), np.float32)
        arrays = self.pair_inputs(pairs, pad_pairs=pad_pairs)
        seq_len, n = arrays[0].shape[1], len(pairs)
        with time_block(f"rerank.forward_s{seq_len}"):
            logits = cross_encoder_forward(
                self.params, *(torch.from_numpy(a).to(self.device) for a in arrays),
                config=self.config, compute_dtype=self.compute_dtype)
        return lambda: logits[:n].float().cpu().numpy()

    def predict(self, pairs: Sequence[Sequence[str]]) -> np.ndarray:
        """Score pairs -> [N] float32 logits."""
        return self.predict_begin(pairs)()


def adaptive_normalize(scores: np.ndarray) -> tuple:
    """Reference's three-mode normalization (document_reranker.py:253-276).
    Returns (normalized [N], method_name)."""
    scores = np.asarray(scores, np.float32)
    rng = float(scores.max() - scores.min()) if scores.size else 0.0
    if rng > 0.01:
        if scores.min() >= 0:
            return scores / float(scores.max()), "max-normalization"
        return (scores - scores.min()) / rng, "min-max-normalization"
    order = np.argsort(-scores, kind="stable")
    out = np.zeros_like(scores)
    for rank, idx in enumerate(order):
        out[idx] = 1.0 - (rank / len(order)) * 0.9
    return out, "rank-based"


class CrossEncoderReranker:
    def __init__(self, model: Optional[CrossEncoderModel], cfg: Optional[RerankConfig] = None) -> None:
        self.model = model
        self.cfg = cfg or RerankConfig()
        self.healthy = self._sanity_check() if model is not None else False

    def _sanity_check(self) -> bool:
        """Load-time discrimination test (reference document_reranker.py:80-123):
        a relevant pair must outscore an irrelevant one."""
        try:
            probes = [
                ("what is the annual rent amount",
                 "The annual rent for the premises is Rs 42,800 payable monthly."),
                ("what is the annual rent amount",
                 "The weather in Paris is mild in spring with occasional rain."),
                ("who is the supplier on the invoice",
                 "Supplier: Bhartiya Enterprises, Chakulia, East Singhbhum."),
                ("who is the supplier on the invoice",
                 "Football matches last ninety minutes plus stoppage time."),
            ]
            scores = self.model.predict(probes)
            ok = scores[0] > scores[1] and scores[2] > scores[3]
            spread = float(max(scores) - min(scores))
            if not ok:
                log.warning("cross-encoder sanity check FAILED (inverted/flat scoring: %s)", scores)
            elif spread < 0.05:
                log.warning("cross-encoder discrimination weak (spread %.4f)", spread)
            return bool(ok)
        except Exception as e:  # noqa: BLE001
            log.warning("cross-encoder sanity check errored: %s", e)
            return False

    def rerank_chunks(self, query: str, chunks: List[dict], *,
                      strategy: str = "Specific", top_k: Optional[int] = None) -> List[dict]:
        """chunks: dicts with 'text'/'chunk_text' + 'retrieval_score'.
        Returns re-sorted chunks with rerank fields attached."""
        if not chunks:
            return chunks
        if strategy == "Aggregation":
            # aggregation queries need breadth, not precision ordering
            return chunks[:top_k] if top_k else chunks

        if self.model is None:
            ranked = sorted(chunks, key=lambda c: c.get("retrieval_score", 0.0), reverse=True)
            for c in ranked:
                c["final_rerank_score"] = float(c.get("retrieval_score", 0.0))
                c["normalization_method"] = "no-model-retrieval-sort"
            return ranked[:top_k] if top_k else ranked

        pairs = []
        for c in chunks[: self.cfg.max_pairs]:
            text = (c.get("text") or c.get("chunk_text") or "").strip()
            pairs.append((query.strip(), text))
        try:
            raw = self.model.predict(pairs)
            normalized, method = adaptive_normalize(raw)
        except Exception as e:  # noqa: BLE001
            log.error("cross-encoder predict failed: %s", e)
            raw = np.zeros(len(pairs), np.float32)
            normalized, method = np.full(len(pairs), 0.5, np.float32), "fallback-uniform"

        for c, r, nrm in zip(chunks, raw, normalized):
            c["cross_encoder_score_raw"] = float(r)
            c["cross_encoder_score"] = float(nrm)
            retrieval = float(c.get("combined_score", c.get("retrieval_score", 0.0)))
            c["final_rerank_score"] = float(nrm * self.cfg.cross_weight + retrieval * self.cfg.retrieval_weight)
            c["normalization_method"] = method
        for c in chunks[len(pairs):]:
            c["final_rerank_score"] = float(c.get("retrieval_score", 0.0)) * self.cfg.retrieval_weight
            c["normalization_method"] = "overflow-unscored"

        ranked = sorted(chunks, key=lambda c: c["final_rerank_score"], reverse=True)
        return ranked[:top_k] if top_k else ranked
