"""Kernel wrappers, each beside its plain PyTorch version.

One module per kernel (pool_norm, flash_attention, fused_ffn, topk), each
with a ``LAUNCHES`` counter; kernel_lib builds and loads the CUDA library.
The modules are not re-exported here, so ``ops.flash_attention`` is the
module (with its counter), not the function.
"""
