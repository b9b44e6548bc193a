"""Keyword-based query intent / complexity analysis
(capability of reference utils.py:167-244)."""

from __future__ import annotations

import re
from dataclasses import dataclass

_INTENT_KEYWORDS = {
    "aggregation": ["total", "sum", "average", "count", "how many", "overall", "combined", "aggregate"],
    "comparison": ["compare", "versus", "vs", "difference", "higher", "lower", "more than", "less than"],
    "temporal": ["when", "date", "year", "month", "period", "duration", "deadline", "expiry", "term"],
    "entity": ["who", "name", "company", "party", "lessor", "lessee", "vendor", "supplier"],
    "amount": ["amount", "cost", "price", "rent", "fee", "charge", "payment", "invoice", "gst", "tax", "rate"],
    "definition": ["what is", "define", "meaning", "explain"],
}

_COMPLEX_MARKERS = [" and ", " or ", ",", ";", "both", "as well as", "along with"]


@dataclass
class QueryAnalysis:
    intent: str
    complexity: str          # simple | moderate | complex
    keywords: list
    word_count: int
    is_question: bool


class QueryAnalyzer:
    def analyze(self, query: str) -> QueryAnalysis:
        q = query.lower().strip()
        words = re.findall(r"[a-z0-9]+", q)

        intent = "general"
        best = 0
        for name, kws in _INTENT_KEYWORDS.items():
            score = sum(1 for kw in kws if kw in q)
            if score > best:
                best, intent = score, name

        clause_hits = sum(q.count(m) for m in _COMPLEX_MARKERS)
        if len(words) <= 6 and clause_hits == 0:
            complexity = "simple"
        elif len(words) <= 15 and clause_hits <= 1:
            complexity = "moderate"
        else:
            complexity = "complex"

        stop = {"the", "a", "an", "is", "of", "in", "on", "to", "for", "and", "or", "what", "be", "was", "are"}
        keywords = [w for w in words if w not in stop and len(w) > 2]
        return QueryAnalysis(
            intent=intent,
            complexity=complexity,
            keywords=keywords,
            word_count=len(words),
            is_question=q.endswith("?") or q.split(" ", 1)[0] in
            ("what", "who", "when", "where", "why", "how", "which", "is", "are", "does", "do"),
        )
