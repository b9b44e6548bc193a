"""Data and tensor parallelism over one process per rank (meshes, the
launcher, the autograd-aware collectives), and the sharded indexes that one
serving process holds over a list of devices."""

from financial_rag_tpu_torch.parallel.mesh import (Mesh, encode_devices, make_mesh,
                                                   search_devices, train_mesh)
from financial_rag_tpu_torch.parallel.sharded_index import ShardedFlatIndex
from financial_rag_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

__all__ = ["Mesh", "make_mesh", "train_mesh", "search_devices", "encode_devices",
           "ShardedFlatIndex", "ShardedIVFIndex"]
