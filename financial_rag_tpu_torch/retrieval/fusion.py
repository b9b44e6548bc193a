"""Score fusion across ranked lists.

Exact math of the reference's two fusion modes
(reference rag_backend.py:722-754):

- RRF: score(c) = sum over lists of 1/(k + rank), rank starting at 1;
- avg: per-list min-max normalization, summed, divided by the number of
  lists (a list with constant scores contributes 0).
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple


def rrf_fuse(ranked_lists: Sequence[Sequence[Hashable]], k: int = 60) -> Dict[Hashable, float]:
    """ranked_lists: sequences of ids in rank order (best first)."""
    combined: Dict[Hashable, float] = {}
    for lst in ranked_lists:
        for rank, cid in enumerate(lst, start=1):
            combined[cid] = combined.get(cid, 0.0) + 1.0 / (k + rank)
    return combined


def minmax_avg_fuse(scored_lists: Sequence[Sequence[Tuple[Hashable, float]]]) -> Dict[Hashable, float]:
    """scored_lists: sequences of (id, score) in rank order."""
    combined: Dict[Hashable, float] = {}
    n = float(len(scored_lists))
    for lst in scored_lists:
        if not lst:
            continue
        scores = [s for _, s in lst]
        mn, mx = min(scores), max(scores)
        for (cid, s) in lst:
            norm = (s - mn) / (mx - mn) if mx > mn else 0.0
            combined[cid] = combined.get(cid, 0.0) + norm
    if n > 0:
        for cid in combined:
            combined[cid] /= n
    return combined
