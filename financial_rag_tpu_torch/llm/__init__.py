from financial_rag_tpu_torch.llm.provider import LLMProvider, NullLLM, get_provider
from financial_rag_tpu_torch.llm.gemini import GeminiProvider

__all__ = ["LLMProvider", "NullLLM", "GeminiProvider", "get_provider"]
