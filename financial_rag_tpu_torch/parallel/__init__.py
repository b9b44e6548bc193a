"""Data and tensor parallelism over one process per rank: meshes, the
launcher and the autograd-aware collectives."""

from financial_rag_tpu_torch.parallel.mesh import Mesh, make_mesh, train_mesh

__all__ = ["Mesh", "make_mesh", "train_mesh"]
