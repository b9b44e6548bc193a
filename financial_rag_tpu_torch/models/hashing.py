"""Deterministic lexical hashing encoder.

Embeds text as the normalized sum of pseudorandom unit vectors keyed by
WordPiece token ids (a random-projection bag-of-words). Cosine similarity
then reflects lexical overlap. Uses:

- a weights-free fallback encoder when real checkpoints are unavailable
  (the reference tree ships only LFS stubs), keeping the whole retrieval
  stack functional end-to-end;
- a meaningful encoder for retrieval-quality tests (golden questions
  actually retrieve the right chunks, unlike random-weight BERT).

API-compatible with models.encoder.Encoder.encode().
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from financial_rag_tpu_torch.tokenizer import WordPieceTokenizer


class HashingEncoder:
    # host-side (numpy) encoder: the serving micro-batcher must NOT wrap it
    # — funneling host encodes through one batcher thread halves throughput
    # (measured 0.53x on the full query path) instead of coalescing device
    # dispatches
    device_backed = False

    def __init__(self, dim: int = 384, salt: int = 0,
                 tokenizer: Optional[WordPieceTokenizer] = None) -> None:
        self.dim = dim
        self.salt = salt
        self.tokenizer = tokenizer or WordPieceTokenizer()
        self._cache: Dict[int, np.ndarray] = {}
        self._skip = {self.tokenizer.pad_id, self.tokenizer.cls_id, self.tokenizer.sep_id}

    def _token_vec(self, token_id: int) -> np.ndarray:
        v = self._cache.get(token_id)
        if v is None:
            rng = np.random.default_rng((token_id + 1) * 2654435761 + self.salt)
            v = rng.standard_normal(self.dim).astype(np.float32)
            v /= np.linalg.norm(v)
            self._cache[token_id] = v
        return v

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            ids = [tid for tid in self.tokenizer.encode(t, max_len=512) if tid not in self._skip]
            if not ids:
                out[i, 0] = 1.0
                continue
            # sublinear term weighting (repeated tokens saturate)
            counts: Dict[int, int] = {}
            for tid in ids:
                counts[tid] = counts.get(tid, 0) + 1
            acc = np.zeros(self.dim, np.float32)
            for tid, c in counts.items():
                acc += (1.0 + np.log(c)) * self._token_vec(tid)
            out[i] = acc / max(np.linalg.norm(acc), 1e-12)
        return out

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]

    def encode_tokens(self, texts: Sequence[str]) -> list:
        """Per-token unit vectors (for the multivector tier in tests)."""
        out = []
        for t in texts:
            ids = [tid for tid in self.tokenizer.encode(t, max_len=130) if tid not in self._skip]
            if not ids:
                ids = [self.tokenizer.unk_id]
            out.append(np.stack([self._token_vec(tid) for tid in ids]))
        return out
