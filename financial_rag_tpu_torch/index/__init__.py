from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.index.ivf import IVFIndex, kmeans, recommended_nlist

__all__ = ["FlatIndex", "IVFIndex", "kmeans", "recommended_nlist"]
