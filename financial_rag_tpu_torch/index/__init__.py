from financial_rag_tpu_torch.index.flat import FlatIndex
from financial_rag_tpu_torch.index.ivf import IVFIndex, kmeans, recommended_nlist
from financial_rag_tpu_torch.index.multivector import MultiVectorIndex

__all__ = ["FlatIndex", "IVFIndex", "MultiVectorIndex", "kmeans", "recommended_nlist"]
