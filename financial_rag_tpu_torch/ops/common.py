"""Shared helpers for the kernel wrappers: integer arithmetic, the lock
that guards their launch counters (a count's ``+= 1`` is a read, an add and
a write, and the serving batchers launch from several threads at once), and
the zero-padding of attention heads to a width a kernel is built for."""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

LAUNCH_LOCK = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def built_head_dim(head_dim: int, built: tuple):
    """The width of ``built`` (ascending) a head of ``head_dim`` runs at:
    the narrowest that holds it, or None above the widest."""
    return next((w for w in built if head_dim <= w), None)


def pad_heads(x: torch.Tensor, num_heads: int, width: int) -> torch.Tensor:
    """[B,S,heads*d] -> [B,S,heads*width], each head's d columns followed
    by zeros (x itself where d == width)."""
    b, s, h = x.shape
    d = h // num_heads
    if d == width:
        return x
    return F.pad(x.view(b, s, num_heads, d), (0, width - d)).view(b, s, num_heads * width)


def unpad_heads(x: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads`: each head's first ``head_dim``
    columns."""
    b, s, h = x.shape
    if h == num_heads * head_dim:
        return x
    return x.view(b, s, num_heads, h // num_heads)[..., :head_dim].reshape(b, s, num_heads * head_dim)
