from financial_rag_tpu_torch.index.flat import FlatIndex

__all__ = ["FlatIndex"]
