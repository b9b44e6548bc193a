from financial_rag_tpu_torch.retrieval.fusion import rrf_fuse, minmax_avg_fuse
from financial_rag_tpu_torch.retrieval.bm25 import BM25
from financial_rag_tpu_torch.retrieval.retriever import ParentContextRetriever
from financial_rag_tpu_torch.retrieval.hybrid import HybridRetriever
from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderReranker
from financial_rag_tpu_torch.retrieval.filters import build_filter, passes_filter

__all__ = [
    "rrf_fuse",
    "minmax_avg_fuse",
    "BM25",
    "ParentContextRetriever",
    "HybridRetriever",
    "CrossEncoderReranker",
    "build_filter",
    "passes_filter",
]
