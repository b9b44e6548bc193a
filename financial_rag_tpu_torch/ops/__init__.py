"""Kernel wrappers, each beside its plain PyTorch version.

One module per kernel family (pool_norm, flash_attention, fused_ffn, topk,
ivf_probe, causal_flash), each with a ``LAUNCHES`` count: an int, or for the four sweeps
of topk a Counter keyed by wrapper name. kernel_lib builds and loads the
CUDA library. The modules are not re-exported here, so
``ops.flash_attention`` is the module (with its count), not the function.
"""

import torch

# torch links MKL statically, and a process's first float exp (and, by the
# same mechanism, log, sin, cos, tanh) that torch splits across two
# intra-op threads can race MKL's lazy set-up: the second thread's half then
# comes out far less accurate, which the plain versions on the CPU pass on
# to every softmax. One single-element call of each on this thread sets MKL
# up before any split call (tests/test_torch_ops.py holds a fresh process's
# first split exp to 1e-6 relative).
for _op in (torch.exp, torch.log, torch.sin, torch.cos, torch.tanh):
    _op(torch.ones(1))
del _op
