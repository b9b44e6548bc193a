"""Autograd-aware collectives over the axes of a :class:`~.mesh.Mesh`.

The JAX package writes none of these: GSPMD inserts them from the sharding
rules (financial_rag_tpu/training/contrastive.py:9-14, 32-58). The port
places them by hand, as Megatron-LM does:

- :func:`copy_to_model` ("f"): identity forward, all-reduce of the
  gradient over the model axis in backward. It goes in front of the
  column-parallel projections, whose input gradients are partial sums.
- :func:`reduce_from_model` ("g"): all-reduce forward, identity backward.
  It closes a row-parallel projection, whose outputs are partial sums.
- :func:`gather_from_data`: the rows of every data rank in rank order, for
  the global negatives of the contrastive loss. Only this rank's rows carry
  a gradient; the other ranks' enter as constants.

The sums (``all_reduce_``, f and g) run in float32. :func:`all_gather`
is ``torch.distributed.all_gather``: on the port's one-card runs the ranks
share the card over ``gloo``, which took it (and ``all_reduce``,
``broadcast``, ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single``) on CUDA tensors in torch 2.11 on the H100 machine
(PERF.md), and NCCL always does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis``; 1 without a mesh or without that axis."""
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def all_reduce_(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """In-place float32 all-reduce of ``t`` over ``axis`` ("sum" or "mean");
    the identity on an axis of size 1. Returns ``t``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    if t.dtype != torch.float32:
        raise TypeError(f"the collectives run in float32, got {t.dtype}")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    if op == "mean":
        t.div_(n)
    elif op != "sum":
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    return t


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in rank
    order, in ``x``'s dtype (no gradient)."""
    n = axis_size(mesh, axis)
    x = x.detach()
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = all_reduce_(grad.float().clone(), ctx.mesh, ctx.axis)
        return g.to(grad.dtype), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(x.float().clone(), mesh, axis).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_model(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Identity forward; backward sums the gradient over ``axis`` (f32)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Sum over ``axis`` forward (f32, in ``x``'s dtype); identity backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh, axis)


def gather_from_data(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Every data rank's rows of ``x`` ([B_local, ...]) in rank order,
    [B_local * dp, ...]. This rank's rows are ``x`` itself (differentiable);
    the others are constants, so each data rank's loss gradient covers only
    its own rows and the ranks' parameter gradients must be summed."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    i, b = mesh.index(axis), x.shape[0]
    full = all_gather(x, mesh, axis)
    return torch.cat([full[:i * b], x, full[(i + 1) * b:]])
