from financial_rag_tpu_torch.ingest.chunker import ChildChunk, ParentChildChunker, ParentChunk
from financial_rag_tpu_torch.ingest.marker_json import parse_marker_json
from financial_rag_tpu_torch.ingest.pipeline import IngestionPipeline

__all__ = [
    "ChildChunk",
    "ParentChunk",
    "ParentChildChunker",
    "parse_marker_json",
    "IngestionPipeline",
]
