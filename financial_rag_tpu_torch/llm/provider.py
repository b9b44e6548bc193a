"""LLM provider interface with graceful no-LLM degradation.

Every LLM touchpoint (query normalization, per-chunk context, answer
synthesis) goes through this interface, and every call site must work when
the provider is NullLLM — matching the reference's fallback-everywhere
behavior (reference rag_backend.py:554-557, api_adapter.py:53-56,
pipeline.py:103-105).
"""

from __future__ import annotations

from typing import List, Optional, Protocol

from financial_rag_tpu_torch.config import LLMConfig
from financial_rag_tpu_torch.device import DeviceLike
from financial_rag_tpu_torch.llm.prompts import QUERY_NORMALIZE, build_answer_prompt, chunk_context_prompt
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("llm.provider")


class LLMProvider(Protocol):
    name: str

    def available(self) -> bool: ...

    def generate(self, prompt: str, *, max_tokens: int = 1024) -> Optional[str]:
        """Return text or None on failure (callers must degrade)."""
        ...


class NullLLM:
    """Provider used when no API key / network is configured."""

    name = "null"

    def available(self) -> bool:
        return False

    def generate(self, prompt: str, *, max_tokens: int = 1024) -> Optional[str]:
        return None


def _safe_generate(provider: LLMProvider, prompt: str, max_tokens: int) -> Optional[str]:
    """Providers should return None on failure, but the degradation contract
    (reference rag_backend.py:554-557) must hold even if one raises."""
    if not provider.available():
        return None
    try:
        return provider.generate(prompt, max_tokens=max_tokens)
    except Exception as e:  # noqa: BLE001 — any provider failure degrades
        log.warning("LLM provider %s failed: %s", getattr(provider, "name", "?"), e)
        return None


def normalize_query(provider: LLMProvider, question: str) -> List[str]:
    """Return [corrected, alt1, alt2]; degrades to [question]."""
    text = _safe_generate(provider, QUERY_NORMALIZE.format(question=question), 256)
    if not text:
        return [question]
    lines = [ln.strip().lstrip("0123456789.- ") for ln in text.splitlines() if ln.strip()]
    queries = [q for q in lines[:3] if q]
    if not queries:
        return [question]
    # the corrected question leads; keep the original out (reference behavior:
    # search uses corrected + 2 alternates)
    return queries


def stream_answer(provider: LLMProvider, question: str, parents,
                  related_queries=()):
    """Generator of answer text deltas, for providers that can stream
    (LocalLLM's segmented on-device generation). Yields nothing when the
    provider can't stream or fails — callers then fall back to
    synthesize_answer, preserving the degradation contract.

    RETURNS True (StopIteration.value) only when the stream ran to
    completion: a mid-generation failure after some deltas were already
    yielded returns False, so callers know the joined deltas are a
    TRUNCATED fragment and must regenerate rather than store it as the
    final answer."""
    gen = getattr(provider, "generate_stream", None)
    if gen is None or not provider.available() or not parents:
        return False
    prompt = build_answer_prompt(question, parents, related_queries)
    try:
        yield from gen(prompt, max_tokens=1024)
        return True
    except Exception as e:  # noqa: BLE001 — stream failure degrades
        log.warning("LLM stream from %s failed: %s",
                    getattr(provider, "name", "?"), e)
        return False


def synthesize_answer(provider: LLMProvider, question: str, parents, related_queries=()) -> str:
    """Answer from parent contexts; degrades to concatenated context."""
    prompt = build_answer_prompt(question, parents, related_queries)
    text = _safe_generate(provider, prompt, 1024)
    if text:
        return text.strip()
    if parents:
        joined = "\n\n".join((p.get("content") or "")[:800] for p in parents[:3])
        return ("LLM unavailable — showing the most relevant context instead.\n\n" + joined)
    return "No relevant context was found for this question."


def chunk_context(provider: LLMProvider, document_excerpt: str, chunk_text: str) -> Optional[str]:
    """Optional succinct chunk context; None when unavailable."""
    text = _safe_generate(provider, chunk_context_prompt(document_excerpt, chunk_text), 128)
    if text:
        return text.strip()[:300]
    return None


def get_provider(cfg: Optional[LLMConfig] = None, device: DeviceLike = None) -> LLMProvider:
    """``device`` is where a local LLM runs (see device.resolve_device)."""
    cfg = cfg or LLMConfig()
    if cfg.provider == "gemini" and cfg.gemini_api_key:
        from financial_rag_tpu_torch.llm.gemini import GeminiProvider

        return GeminiProvider(cfg)
    if cfg.provider == "local" and cfg.local_checkpoint:
        from financial_rag_tpu_torch.llm.local_llm import LocalLLM

        return LocalLLM(cfg, device=device)   # loads lazily; degrades to NullLLM semantics
    return NullLLM()
