from financial_rag_tpu_torch.utils.logging import get_logger
from financial_rag_tpu_torch.utils.timing import TimingLogger, time_block, time_function
from financial_rag_tpu_torch.utils.sanitize import validate_and_sanitize_query
from financial_rag_tpu_torch.utils.analyzer import QueryAnalyzer
from financial_rag_tpu_torch.utils.ratelimit import RateLimiter
from financial_rag_tpu_torch.utils.misc import safe_mean, safe_divide, assess_chunk_quality

__all__ = [
    "get_logger",
    "TimingLogger",
    "time_block",
    "time_function",
    "validate_and_sanitize_query",
    "QueryAnalyzer",
    "RateLimiter",
    "safe_mean",
    "safe_divide",
    "assess_chunk_quality",
]
