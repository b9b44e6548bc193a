"""BM25 (Okapi) sparse scorer — vectorized numpy implementation.

Same scoring semantics as the rank_bm25.BM25Okapi library the reference
uses (reference rag_backend.py:776-788): k1=1.5, b=0.75, and the Okapi idf
floor (negative idf values replaced by epsilon * average positive idf,
epsilon=0.25). Tokenization at the call site is whitespace .split(),
matching the reference. A C++ scorer in financial_rag_tpu_torch/native is
the fast path for large corpora.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np


class BM25:
    def __init__(self, corpus_tokens: Sequence[Sequence[str]],
                 k1: float = 1.5, b: float = 0.75, epsilon: float = 0.25) -> None:
        self.k1 = k1
        self.b = b
        self.epsilon = epsilon
        self.n_docs = len(corpus_tokens)
        self.doc_lens = np.asarray([len(d) for d in corpus_tokens], np.float32)
        self.avgdl = float(self.doc_lens.mean()) if self.n_docs else 0.0

        self.term_freqs: List[Dict[str, int]] = [dict(Counter(d)) for d in corpus_tokens]
        df: Dict[str, int] = {}
        for tf in self.term_freqs:
            for t in tf:
                df[t] = df.get(t, 0) + 1

        self.idf: Dict[str, float] = {}
        negative: List[str] = []
        idf_sum = 0.0
        for t, n in df.items():
            v = math.log((self.n_docs - n + 0.5) / (n + 0.5))
            self.idf[t] = v
            idf_sum += v
            if v < 0:
                negative.append(t)
        avg_idf = idf_sum / len(self.idf) if self.idf else 0.0
        floor = self.epsilon * avg_idf
        for t in negative:
            self.idf[t] = floor

    def get_scores(self, query_tokens: Sequence[str]) -> np.ndarray:
        scores = np.zeros(self.n_docs, np.float32)
        if not self.n_docs:
            return scores
        norm = self.k1 * (1.0 - self.b + self.b * self.doc_lens / (self.avgdl or 1.0))
        for t in query_tokens:
            idf = self.idf.get(t)
            if idf is None:
                continue
            tf = np.asarray([d.get(t, 0) for d in self.term_freqs], np.float32)
            scores += idf * tf * (self.k1 + 1.0) / (tf + norm)
        return scores


class _NativeScorer:
    def __init__(self, texts):
        from financial_rag_tpu_torch.native import NativeBM25

        self._impl = NativeBM25(list(texts))

    def score_text(self, query_text: str) -> np.ndarray:
        return self._impl.get_scores(query_text)


class _PyScorer:
    def __init__(self, texts):
        self._impl = BM25([t.split() for t in texts])

    def score_text(self, query_text: str) -> np.ndarray:
        return self._impl.get_scores(query_text.split())


def build_scorer(texts) -> "object":
    """Uniform text-in scorer: C++ inverted index when built, numpy BM25
    otherwise (identical scores — verified in tests/test_torch_native.py)."""
    try:
        from financial_rag_tpu_torch import native

        if native.available():
            return _NativeScorer(texts)
    except Exception:  # noqa: BLE001 — any native failure falls back
        pass
    return _PyScorer(texts)
