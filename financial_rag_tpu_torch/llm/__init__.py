from financial_rag_tpu_torch.llm.provider import LLMProvider, NullLLM, get_provider
from financial_rag_tpu_torch.llm.gemini import GeminiProvider
from financial_rag_tpu_torch.llm.local_llm import LocalLLM

__all__ = ["LLMProvider", "NullLLM", "GeminiProvider", "LocalLLM", "get_provider"]
