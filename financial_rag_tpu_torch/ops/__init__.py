"""Kernel wrappers, each beside its plain PyTorch version.

One module per kernel family (pool_norm, flash_attention, fused_ffn, topk,
ivf_probe, causal_flash), each with a ``LAUNCHES`` count: an int, or for the four sweeps
of topk a Counter keyed by wrapper name. kernel_lib builds and loads the
CUDA library. The modules are not re-exported here, so
``ops.flash_attention`` is the module (with its count), not the function.
"""
