"""The three live prompt templates (SURVEY.md §0: query normalizer
rag_backend.py:537-543, answer synthesis rag_backend.py:1245-1251,
chunk context pipeline.py:94-98 — re-authored, same behavioral intent)."""

from __future__ import annotations

from typing import List, Sequence

QUERY_NORMALIZE = """You rewrite search queries for a financial-document retrieval system.
Given the user question below, return exactly three lines:
1. the corrected question (fix typos/grammar, keep meaning)
2. an alternative phrasing emphasizing domain keywords
3. another alternative phrasing using synonyms

Question: {question}
"""


def build_answer_prompt(question: str, parents: Sequence[dict],
                        related_queries: Sequence[str] = (),
                        max_parents: int = 5, max_chars_each: int = 3000) -> str:
    """Answer-synthesis prompt: <=max_parents context sections, each capped
    (reference caps: 5 parents in the hybrid path, 6 x 3000 chars in the
    dense path api_adapter.py:15-29)."""
    sections: List[str] = []
    for i, p in enumerate(parents[:max_parents], start=1):
        content = (p.get("content") or "")[:max_chars_each]
        doc = p.get("document_id", "unknown")
        pages = f"pages {p.get('page_start')}-{p.get('page_end')}"
        sections.append(f"[Context {i}] (document: {doc}, {pages})\n{content}")
    related = ""
    if related_queries:
        related = "\nRelated phrasings considered: " + "; ".join(related_queries) + "\n"
    ctx = "\n\n".join(sections) if sections else "(no context retrieved)"
    return (
        "You are a precise financial-document assistant. Answer the question "
        "using ONLY the context sections below. Quote exact figures, dates, "
        "names and amounts as written. If the context does not contain the "
        "answer, say so explicitly.\n\n"
        f"{ctx}\n{related}\n"
        f"Question: {question}\n"
        "Answer:"
    )


def chunk_context_prompt(document_excerpt: str, chunk_text: str) -> str:
    """Anthropic-style contextual-retrieval blurb (<=300 chars) situating a
    child chunk within its document."""
    return (
        "Here is an excerpt of a document, then one chunk from it. Write a "
        "short context (max 300 characters) situating the chunk within the "
        "document to improve search retrieval of the chunk. Respond only "
        "with the context.\n\n"
        f"<document>\n{document_excerpt[:4000]}\n</document>\n\n"
        f"<chunk>\n{chunk_text[:2000]}\n</chunk>"
    )
