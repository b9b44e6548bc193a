"""financial_rag_tpu_torch — the PyTorch/CUDA port of financial_rag_tpu.

The same retrieval framework (dual-encoder dense embedding, a device-resident
flat index with fused top-k, hybrid BM25 fusion, cross-encoder rerank,
parent/child ingestion) on PyTorch, with every accelerator kernel of the
served path written by hand in CUDA C++ for Hopper (sm_90a). It imports
nothing of the JAX package: modules without JAX in them are kept as copies.

Layering (bottom-up):
  csrc/       hand-written CUDA kernels, built with nvcc at first use
  ops/        kernel wrappers, each beside its plain PyTorch version
  models/     BERT encoder / cross-encoder stacks + checkpoint IO
  tokenizer/  exact WordPiece (host side)
  index/      device-resident flat vector index
  store/      host-side parent KV store, child metadata, feedback DB
  ingest/     Marker-JSON parsing, two-tier chunker, streaming pipeline
  retrieval/  multi-query dual-encoder retrieval, fusion, BM25, rerank
  llm/        optional LLM hooks (query normalize / answer synthesis)
"""

from financial_rag_tpu_torch.version import __version__

__all__ = ["__version__"]
