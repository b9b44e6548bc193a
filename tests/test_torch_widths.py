"""The widths the CUDA path takes through its generic routes, in the port
against the JAX package.

Published checkpoints whose widths no tuned kernel design was built for:
ms-marco-TinyBERT-L-4 (hidden 312, 12 heads of 26, FFN 1,200),
ms-marco-TinyBERT-L-2-v2 (128, 2 heads of 64, FFN 512), BERT-Small
(512, 8 heads of 64, FFN 2,048) and open_llama_3b_v2 (hidden 3,200, 32 heads
of 100). On the card K2 and K10 read heads narrower than 32 or 64 where
they lie (at the widths ``fwd_reads_in_place`` and ``bwd_reads_in_place``
name), K9 reads heads narrower than 64 or 128 where they lie (at the
widths ``causal_reads_in_place`` names), any other width is padded in a
copy, and K3 runs its two products at run-time extents. Here, on the CPU,
each plain version the kernels are held against runs on the same numpy
inputs as the JAX function at those widths (Pallas in interpret mode); the
padded route's arithmetic (pad, scale from the true head_dim, drop the
padded columns) is checked against the unpadded plain version, and the
in-place reads (a 16-byte aligned window of the built width, the columns
that are not the head's zeroed) of K2, K10 and K9 against the Pallas
kernels; the route rules against the C entries' checks; the generic K3
plan covers every token tile, output column and k step; and whole models
at those widths (a cross-encoder, a bi-encoder, a decoder at heads of 100,
the weight converters) match the JAX package.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from financial_rag_tpu.config import ModelConfig as JaxModelConfig
from financial_rag_tpu.models import bert as jbert
from financial_rag_tpu.models import checkpoint as jckpt
from financial_rag_tpu.models import decoder as jdec
from financial_rag_tpu.ops import flash_attention as jax_flash_attention
from financial_rag_tpu.ops.causal_flash import causal_flash_prefill as jax_causal_flash
from financial_rag_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from financial_rag_tpu_torch.config import FrameworkConfig, ModelConfig
from financial_rag_tpu_torch.models import bert, checkpoint
from financial_rag_tpu_torch.models import decoder as tdec
from financial_rag_tpu_torch.ops import causal_flash as k9
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.ops import fused_ffn as ffn
from financial_rag_tpu_torch.ops import topk
from financial_rag_tpu_torch.ops.common import built_head_dim, pad_heads, unpad_heads
from financial_rag_tpu_torch.runtime import check_supported
from financial_rag_tpu_torch.training import contrastive

torch.set_num_threads(2)

H100_SMS = 132
# (hidden, heads, intermediate) of the published encoder checkpoints
TINYBERT_L4 = (312, 12, 1200)
TINYBERT_L2 = (128, 2, 512)
BERT_SMALL = (512, 8, 2048)


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _attn_inputs(seed: int, b: int, s: int, h: int):
    """q, k, v, dout [B,S,H] and a key bias: row 1 padded, the last row
    fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[1, s // 2:] = 0
    mask[-1] = 0
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    return q, k, v, do, bias


# ------------------------------------------------------------ K2 and K10

HEAD_DIMS = [26, 16, 48]


@pytest.mark.parametrize("s", [48, 37])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_flash_attention_plain_matches_pallas_at_odd_head_dims(head_dim, s):
    """K2's plain version against the Pallas kernel (interpret mode) at 12
    heads of 26 (TinyBERT-L-4), 16 and 48, f32, S = 48 and a ragged 37,
    a padded row and a fully masked one: within 1e-5."""
    b, heads = 3, 12
    q, k, v, _, bias = _attn_inputs(head_dim + s, b, s, heads * head_dim)
    ref = jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(bias.reshape(b, 1, 1, s)), num_heads=heads,
                              interpret=True)
    out = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(bias), num_heads=heads)
    assert out.shape == (b, s, heads * head_dim)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_flash_attention_bwd_plain_matches_pallas_vjp_at_odd_head_dims(head_dim, dtype):
    """K10's plain version against jax.vjp of the Pallas kernel at 12 heads
    of 26, 16 and 48, S = 40: f32 within 2e-5 of each gradient's largest
    value, bf16 within 2^-7 (the bars of the head-32 and head-64 test);
    padded keys get exact zeros in dk and dv."""
    b, s, heads = 3, 40, 12
    q, k, v, do, bias = _attn_inputs(head_dim, b, s, heads * head_dim)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    jbias = jnp.asarray(bias)[:, None, None, :]
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention(a, b_, c, jbias, num_heads=heads,
                                                          interpret=True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    got = fa.flash_attention_bwd_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                       torch.from_numpy(bias), torch.from_numpy(do).to(tdt),
                                       num_heads=heads)
    rtol = 2e-5 if dtype == "float32" else 2.0 ** -7
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = _np(g), _np(w)
        assert g.shape == q.shape
        assert np.abs(g - w).max() <= rtol * np.abs(w).max(), (name, np.abs(g - w).max())
        if name != "dq":
            assert (g[1, s // 2:] == 0).all()


def _scaled_plain(q, k, v, bias, heads: int, head_dim: int, width: int):
    """What the padded route computes, on the CPU: q, k, v zero-padded to
    ``width`` a head, the scores scaled by 1 / sqrt(head_dim) (the plain
    version scales by the padded width, so q carries the difference), the
    output's padded columns dropped."""
    qp, kp, vp = (pad_heads(t, heads, width) for t in (q, k, v))
    qp = qp * (width / head_dim) ** 0.5
    out = fa.flash_attention_plain(qp, kp, vp, bias, num_heads=heads)
    return out, unpad_heads(out, heads, head_dim)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_padded_heads_compute_the_same_attention(head_dim):
    """Zero columns add nothing to q.k and give zero output columns: heads
    of 26, 16 and 48 padded to their built width (32, 32, 64), scaled by
    the true head_dim, give the unpadded attention within f32 rounding, and
    the padded columns are exactly zero. A scale taken from the padded
    width misses that by far (the control the card phase runs too)."""
    b, s, heads = 2, 33, 12
    width = built_head_dim(head_dim, fa.FWD_HEAD_DIMS)
    assert width == (32 if head_dim <= 32 else 64)
    q, k, v, _, bias = (torch.from_numpy(a) for a in _attn_inputs(head_dim, b, s,
                                                                    heads * head_dim))
    want = fa.flash_attention_plain(q, k, v, bias, num_heads=heads)
    padded, got = _scaled_plain(q, k, v, bias, heads, head_dim, width)
    assert padded.shape == (b, s, heads * width)
    assert (padded.view(b, s, heads, width)[..., head_dim:] == 0).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    wrong_scale = unpad_heads(fa.flash_attention_plain(
        *(pad_heads(t, heads, width) for t in (q, k, v)), bias, num_heads=heads), heads, head_dim)
    assert (wrong_scale - want).abs().max() > 1e-2


def _windows(x, heads: int, head_dim: int, width: int, zero: bool):
    """Head g of the [B, S, H] rows x as a ``width``-wide window from
    column g * head_dim rounded down to a multiple of 8 (a 16-byte
    boundary), [B, heads, S, width]: the head at columns off = g * head_dim
    mod 8 .. off + head_dim - 1, its neighbours' columns (past H, zeros)
    around it, zeroed where ``zero``; and the offsets."""
    offs = [g * head_dim % 8 for g in range(heads)]
    xp = torch.nn.functional.pad(x, (0, width))
    w = torch.stack([xp[..., g * head_dim - o:g * head_dim - o + width]
                     for g, o in enumerate(offs)], dim=1)
    if zero:
        for g, o in enumerate(offs):
            w[:, g, :, :o] = 0
            w[:, g, :, o + head_dim:] = 0
    return w, offs


def _own_columns(w, offs, head_dim: int):
    """Each head's own columns of [B, heads, S, width] windows -> [B, S, H]."""
    b, _, s, _ = w.shape
    return torch.stack([w[:, g, :, o:o + head_dim] for g, o in enumerate(offs)],
                       dim=2).reshape(b, s, len(offs) * head_dim)


def _window_read(q, k, v, bias, heads: int, head_dim: int, width: int, zero_q: bool = True,
                 scale_width: bool = False):
    """K2's in-place read, emulated in plain torch: head g read as a
    ``width``-wide window of the [B, S, H] rows (:func:`_windows`); Q's and
    K's columns outside the head's zeroed (``zero_q``; V's reach only
    output columns that are dropped); the scores scaled by 1 /
    sqrt(head_dim) (``scale_width``: by the window's width); softmax over
    the keys with the bias; P V; each head's own output columns kept."""
    b, s, h = q.shape
    qw, offs = _windows(q, heads, head_dim, width, zero_q)
    kw, _ = _windows(k, heads, head_dim, width, zero_q)
    vw, _ = _windows(v, heads, head_dim, width, False)
    scale = (width if scale_width else head_dim) ** -0.5
    scores = qw @ kw.transpose(-1, -2) * scale + bias.reshape(b, 1, 1, s)
    return _own_columns(torch.softmax(scores, dim=-1) @ vw, offs, head_dim)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_in_place_window_read_matches_pallas(head_dim):
    """K2's arithmetic at 12 heads of 26, 16 and 48 read in place: each head
    as a 16-byte aligned window of the built width (32, 32, 64) holding its
    neighbours' columns, Q's extra columns zeroed, the true head_dim's
    scale, O's extra columns dropped, equals the Pallas kernel (interpret
    mode) within 1e-5 in f32, a padded row and a fully masked one included.
    Two controls miss it by far: Q's and K's extra columns left unzeroed
    (the neighbours' q.k reaches the scores), and the scale of the window's
    width."""
    b, s, heads = 3, 40, 12
    width = built_head_dim(head_dim, fa.FWD_HEAD_DIMS)
    q, k, v, _, bias = _attn_inputs(head_dim + 7, b, s, heads * head_dim)
    ref = _np(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  jnp.asarray(bias.reshape(b, 1, 1, s)), num_heads=heads,
                                  interpret=True))
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    got = _window_read(tq, tk, tv, tb, heads, head_dim, width)
    assert got.shape == (b, s, heads * head_dim)
    np.testing.assert_allclose(_np(got), ref, atol=1e-5)
    unzeroed = _window_read(tq, tk, tv, tb, heads, head_dim, width, zero_q=False)
    wrong_scale = _window_read(tq, tk, tv, tb, heads, head_dim, width, scale_width=True)
    assert np.abs(_np(unzeroed) - ref).max() > 0.1
    assert np.abs(_np(wrong_scale) - ref).max() > 1e-2


@pytest.mark.parametrize("s", [64, 512])
def test_k2_route_rule_mirrors_the_cuda_entry(s):
    """fwd_reads_in_place names the widths K2 reads where they lie: every
    multiple of 8 up to 64 (16, 32, 48, 64: both designs), and every even
    head_dim the attn_fwd_kernel block runs whose 16-byte aligned window
    fits the built width (26, 28 and 2 at any S; 50 only at S <= 64); an
    odd head_dim, one whose window does not fit (30: up to 6 columns before
    the head and 30 of its own exceed 32), and 50 above S = 64 (the TMA
    design has no window) take the padded copy; above 64 none. The window's
    offset, head * head_dim mod 8, is at most 8 - head_dim's lowest set
    bit, for every head of a layer of up to 64. A windowed head also needs
    rows of whole 16-byte chunks (H a multiple of 8): 26 at 3 or 6 heads
    (K11's local heads of TinyBERT-L-4 at tp 4 or 2) and 28 at 3 take the
    copy; a multiple of 8 reads in place at any head count."""
    for d in (16, 26, 32, 48, 64, 8, 24, 28, 2):
        assert fa.fwd_reads_in_place(d, s, 12 * d), d
    for d in (25, 1, 33, 63, 30, 62):
        assert not fa.fwd_reads_in_place(d, s, 12 * d), d
    assert fa.fwd_reads_in_place(50, s, 12 * 50) == (s <= 64)
    assert not fa.fwd_reads_in_place(72, s, 12 * 72) and not fa.fwd_reads_in_place(80, s, 12 * 80)
    for d, heads in ((26, 3), (26, 6), (26, 1), (28, 3), (50, 2)):
        assert not fa.fwd_reads_in_place(d, s, heads * d), (d, heads)
    for d, heads in ((26, 4), (26, 8), (28, 2)):
        assert fa.fwd_reads_in_place(d, s, heads * d), (d, heads)
    for d in (16, 48):
        assert fa.fwd_reads_in_place(d, s, 3 * d), d
    for d in (26, 28, 2, 50):
        built = built_head_dim(d, fa.FWD_HEAD_DIMS)
        assert max(g * d % 8 for g in range(64)) + d <= built


@pytest.mark.parametrize("head_dim,s,in_place", [(16, 512, True), (26, 512, True),
                                                 (32, 512, True), (48, 512, True),
                                                 (64, 512, True), (26, 64, True), (48, 64, True),
                                                 (50, 64, True), (50, 512, False),
                                                 (25, 64, False), (25, 512, False)])
def test_k2_wrapper_passes_heads_in_place(monkeypatch, head_dim, s, in_place):
    """On device tensors the wrapper hands the C entry q, k and v as they
    lie (H = heads * head_dim) at the widths the rule reads in place, with
    no pad copy and an output at the true width; elsewhere the heads padded
    to the built width (H = heads * 32 or 64), and the padded output cut
    back. The entry's head_dim is always the true one."""
    from financial_rag_tpu_torch.ops import kernel_lib

    heads = 12
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, s, heads * head_dim, **meta)
    bias = torch.zeros(2, s, device="meta")
    calls, pads = [], []
    real_pad = fa.pad_heads
    monkeypatch.setattr(kernel_lib, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(kernel_lib, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(fa, "pad_heads", lambda *a: pads.append(a[2]) or real_pad(*a))
    out = fa.flash_attention(q, q, q, bias, num_heads=heads)
    assert out.shape == q.shape
    (_, entry, _, *args), = calls
    width = built_head_dim(head_dim, fa.FWD_HEAD_DIMS)
    assert entry == "frag_flash_attention"
    assert args[5:] == [2, s, heads * (head_dim if in_place else width), heads, head_dim]
    assert pads == ([] if in_place else [width] * 3)


@pytest.mark.parametrize("heads,tp,in_place", [(3, None, False), (6, None, False),
                                                (12, 2, False), (12, 4, False), (12, 1, True),
                                                (8, 2, True)])
def test_k2_wrapper_pads_rows_that_are_not_whole_chunks(monkeypatch, heads, tp, in_place):
    """Heads of 26 over rows whose width is not a multiple of 8 columns (3
    or 6 heads, as K11 gives TinyBERT-L-4's 12 at tp 4 or 2) reach the C
    entry padded to 32 columns a head, through flash_attention and through
    flash_attention_tp; 4 or more heads a multiple of 4 are read in place."""
    from types import SimpleNamespace

    from financial_rag_tpu_torch.ops import kernel_lib

    s, head_dim = 512, 26
    local = heads // (tp or 1)
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, s, local * head_dim, **meta)
    bias = torch.zeros(2, s, device="meta")
    calls, pads = [], []
    real_pad = fa.pad_heads
    monkeypatch.setattr(kernel_lib, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(kernel_lib, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(fa, "pad_heads", lambda *a: pads.append(a[2]) or real_pad(*a))
    if tp is None:
        out = fa.flash_attention(q, q, q, bias, num_heads=heads)
    else:
        out = fa.flash_attention_tp(q, q, q, bias, num_heads=heads,
                                    mesh=SimpleNamespace(shape={"model": tp}), head_dim=head_dim)
    assert out.shape == q.shape
    (_, _, _, *args), = calls
    assert args[5:] == [2, s, local * (head_dim if in_place else 32), local, head_dim]
    assert pads == ([] if in_place else [32] * 3)


def _window_bwd(q, k, v, bias, do, heads: int, head_dim: int, width: int, zero: bool = True,
                scale_width: bool = False):
    """K10's in-place read at a head not of whole 16-byte chunks, emulated
    in plain torch: q, k, v and dO of head g as ``width``-wide windows
    (:func:`_windows`), the columns outside the head zeroed in all four
    (``zero``), the scores scaled by 1 / sqrt(head_dim) (``scale_width``:
    by the window's width); dV = P^T dO, dP = dO V^T, dS = P o (dP - D),
    dQ = dS K * scale, dK = dS^T Q * scale; each head's own columns of dq,
    dk and dv kept."""
    b, s, _ = q.shape
    (qw, offs), (kw, _), (vw, _), (ow, _) = (_windows(t, heads, head_dim, width, zero)
                                              for t in (q, k, v, do))
    scale = (width if scale_width else head_dim) ** -0.5
    p = torch.softmax(qw @ kw.transpose(-1, -2) * scale + bias.reshape(b, 1, 1, s), dim=-1)
    dv = p.transpose(-1, -2) @ ow
    dp = ow @ vw.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq, dk = ds @ kw * scale, ds.transpose(-1, -2) @ qw * scale
    return tuple(_own_columns(t, offs, head_dim) for t in (dq, dk, dv))


@pytest.mark.parametrize("head_dim", [26, 28, 16])
def test_k10_in_place_window_read_matches_pallas_vjp(head_dim):
    """K10's arithmetic at 12 heads of 26, 28 and 16 read in place: q, k, v
    and dO of each head as a 16-byte aligned window of 32 columns holding
    its neighbours' columns, those zeroed in all four, the true head_dim's
    scale, each head's own columns of dq, dk and dv kept, equals jax.vjp of
    the Pallas kernel (interpret mode) within 2e-5 of each gradient's
    largest value in f32, a padded row and a fully masked one included.
    Two controls miss it by far: the neighbours' columns left unzeroed, and
    the scale of the window's width."""
    b, s, heads = 3, 40, 12
    q, k, v, do, bias = _attn_inputs(head_dim + 11, b, s, heads * head_dim)
    jbias = jnp.asarray(bias)[:, None, None, :]
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention(a, b_, c, jbias, num_heads=heads,
                                                          interpret=True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = [_np(w) for w in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo, tb = (torch.from_numpy(a) for a in (q, k, v, do, bias))
    got = _window_bwd(tq, tk, tv, tb, tdo, heads, head_dim, 32)
    unzeroed = _window_bwd(tq, tk, tv, tb, tdo, heads, head_dim, 32, zero=False)
    wrong_scale = _window_bwd(tq, tk, tv, tb, tdo, heads, head_dim, 32, scale_width=True)
    for name, g, u, ws, w in zip(("dq", "dk", "dv"), got, unzeroed, wrong_scale, want):
        assert g.shape == (b, s, heads * head_dim)
        top = np.abs(w).max()
        assert np.abs(_np(g) - w).max() <= 2e-5 * top, (name, np.abs(_np(g) - w).max())
        assert np.abs(_np(u) - w).max() > 1e-2 * top, name
        assert np.abs(_np(ws) - w).max() > 1e-2 * top, name


def _causal_window_read(q, k, v, pad, heads: int, head_dim: int, width: int, zero: bool = True,
                        scale_width: bool = False):
    """K9's in-place read at heads not of whole 16-byte chunks (one kv head
    a query head), emulated in plain torch: q, k and v of head g as
    ``width``-wide windows (:func:`_windows`), Q's and K's columns outside
    the head zeroed (``zero``), the causal, left-padded softmax of the
    scores scaled by 1 / sqrt(head_dim) (``scale_width``: by the window's
    width), P V, each head's own output columns kept, padding rows zero."""
    b, s, _ = q.shape
    qw, offs = _windows(q, heads, head_dim, width, zero)
    kw, _ = _windows(k, heads, head_dim, width, zero)
    vw, _ = _windows(v, heads, head_dim, width, False)
    scale = (width if scale_width else head_dim) ** -0.5
    pos = torch.arange(s)
    allow = (pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] >= pad.view(b, 1, 1))
    scores = (qw @ kw.transpose(-1, -2) * scale).masked_fill(~allow[:, None], float("-inf"))
    o = torch.nan_to_num(torch.softmax(scores, dim=-1)) @ vw
    out = _own_columns(o, offs, head_dim)
    return torch.where((pos[None, :] >= pad.view(b, 1))[..., None], out, torch.zeros_like(out))


@pytest.mark.parametrize("d,width", [(100, 128), (98, 128), (102, 128)])
def test_k9_in_place_window_read_matches_pallas(d, width):
    """K9's arithmetic at 8 heads of 100 (open_llama_3b_v2), 98 and 102 read
    in place: q, k and v of each head as a 16-byte aligned window of 128
    columns holding its neighbours' columns, Q's and
    K's outside the head zeroed, the true head_dim's scale, each head's own
    output columns kept, equals the Pallas kernel (interpret mode, blocks
    of 128) within 1e-5 in f32 on the real rows, left pads 0 and 37. Two
    controls miss it by far: Q's and K's extra columns left unzeroed, and
    the scale of the window's width."""
    b, s, heads, pads = 2, 256, 8, (0, 37)
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, s, heads * d)).astype(np.float32) for _ in range(3))
    pad = np.asarray(pads, np.int32)
    want = _np(jax_causal_flash(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pad),
                                num_q_heads=heads, num_kv_heads=heads, block_q=128, block_k=128,
                                interpret=True))
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, pad))
    got = _np(_causal_window_read(tq, tk, tv, tp, heads, d, width))
    unzeroed = _np(_causal_window_read(tq, tk, tv, tp, heads, d, width, zero=False))
    wrong_scale = _np(_causal_window_read(tq, tk, tv, tp, heads, d, width, scale_width=True))
    for row, p in enumerate(pads):
        np.testing.assert_allclose(got[row, p:], want[row, p:], atol=1e-5, rtol=0)
        assert np.abs(unzeroed[row, p:] - want[row, p:]).max() > 0.1
        assert np.abs(wrong_scale[row, p:] - want[row, p:]).max() > 1e-2
    assert max(g * d % 8 for g in range(heads)) + d <= width


CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"


def _c_rule(source: str, name: str):
    """The body of ``static bool name(...)`` in csrc/``source`` as a Python
    function of the same arguments: C's &&, ||, !, ?: and declarations
    rewritten, its integer arithmetic (on non-negative values) unchanged."""
    text = (CSRC / source).read_text()
    m = re.search(r"static bool " + name + r"\(([^)]*)\) \{\n(.*?)\n\}", text, re.S)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    lines = []
    for line in m.group(2).splitlines():
        line = line.strip().rstrip(";")
        line = re.sub(r"const int (\w+) = (.+) \? (.+) : (.+)", r"\1 = (\3 if \2 else \4)", line)
        line = re.sub(r"^if \((.*)\) return (.*)$", r"if \1: return \2", line)
        line = line.replace("&&", " and ").replace("||", " or ").replace("!=", "<>")
        line = line.replace("!", " not ").replace("<>", "!=")
        lines.append("    " + line)
    env = {"FRAG_BF16": 1, "FRAG_F32": 0, "true": True, "false": False}
    exec(f"def rule({', '.join(args)}):\n" + "\n".join(lines), env)
    return env["rule"]


def test_k10_route_rule_mirrors_the_cuda_entry():
    """bwd_reads_in_place names exactly the widths the C entry's check
    (``bwd_reads_in_place`` in csrc/flash_attention_bwd.cu) reads in place,
    at every head_dim 1-64 over 1-16 heads (S does not enter): every multiple of 8
    (16, 32, 48, 64 among them), 26 and 28 at head counts whose rows are
    whole 16-byte chunks (12, 8, 4: not 3 or 6, K11's local heads of
    TinyBERT-L-4 at tp 4 or 2), never 30, an odd width or an even one above
    32 not a multiple of 8 (50). The window's offset, head * head_dim mod
    8, is at most 8 - head_dim's lowest set bit, for every head of a layer
    of up to 64."""
    c_rule = _c_rule("flash_attention_bwd.cu", "bwd_reads_in_place")
    for d in range(1, 65):
        for heads in range(1, 17):
            assert fa.bwd_reads_in_place(d, heads * d) == c_rule(d, heads * d), (d, heads)
    for d in (16, 26, 28, 32, 48, 64):
        assert fa.bwd_reads_in_place(d, 12 * d), d
    for d, heads in ((26, 3), (26, 6), (30, 12), (25, 12), (50, 12), (62, 12)):
        assert not fa.bwd_reads_in_place(d, heads * d), (d, heads)
    for d in (26, 28):
        assert max(g * d % 8 for g in range(64)) + d <= 32


def test_k9_route_rule_mirrors_the_cuda_entry():
    """causal_reads_in_place names exactly the widths the C entry's check
    (``reads_in_place`` in csrc/causal_flash.cu) reads in place, at every
    head_dim 1-128, 1-8 kv heads and GQA groups 1-4, bf16 and f32: in f32
    every even width; in bf16 64 and every multiple of 8 above it (80, 96
    among them) at any group, and 100 (open_llama_3b_v2), 98 and 102 as
    windows where one kv head serves one query head and the rows are whole
    16-byte chunks (32 / 32 heads of 100: yes; 4 / 2 or 3 / 3: no); never
    an odd width, a bf16 width below 64 (52, 48, 32: the head-64 kernel
    takes only whole heads), nor 126, whose window would not fit 128. The
    windows' offsets fit 128 for every head of a layer of up to 64."""
    c_rule = _c_rule("causal_flash.cu", "reads_in_place")
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for d in range(1, 129):
            for hkv in range(1, 9):
                for group in (1, 2, 3, 4):
                    hq = hkv * group
                    assert (k9.causal_reads_in_place(d, hq, hkv, dtype)
                            == c_rule(d, hq, hkv, code)), (d, hq, hkv, dtype)
    bf16 = torch.bfloat16
    assert all(k9.causal_reads_in_place(d, 32, 32, bf16) for d in (80, 96, 100, 64, 128, 98, 102))
    assert k9.causal_reads_in_place(80, 32, 8, bf16) and k9.causal_reads_in_place(96, 12, 2, bf16)
    for d, hq, hkv in ((100, 4, 2), (100, 3, 3), (126, 4, 4), (52, 8, 8), (48, 14, 2), (32, 14, 2),
                       (25, 4, 4), (99, 8, 8)):
        assert not k9.causal_reads_in_place(d, hq, hkv, bf16), (d, hq, hkv)
    assert k9.causal_reads_in_place(100, 4, 2, torch.float32)
    assert k9.causal_reads_in_place(52, 8, 8, torch.float32)
    assert not k9.causal_reads_in_place(25, 4, 4, torch.float32)
    for d in (100, 98, 102):
        assert max(g * d % 8 for g in range(64)) + d <= 128


def _capture_launches(monkeypatch, module):
    """Launch nothing, record the launches and the pad copies' widths."""
    from financial_rag_tpu_torch.ops import kernel_lib

    calls, pads = [], []
    real_pad = module.pad_heads
    monkeypatch.setattr(kernel_lib, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(kernel_lib, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(module, "pad_heads", lambda *a: pads.append(a[2]) or real_pad(*a))
    return calls, pads


@pytest.mark.parametrize("head_dim,s,heads,in_place", [
    (16, 512, 12, True), (26, 512, 12, True), (26, 128, 12, True), (48, 512, 12, True),
    (48, 128, 12, True), (32, 512, 12, True), (64, 128, 12, True), (26, 512, 6, False),
    (26, 512, 3, False), (30, 512, 12, False), (25, 64, 12, False), (50, 512, 12, False)])
def test_k10_wrapper_passes_heads_in_place(monkeypatch, head_dim, s, heads, in_place):
    """On device tensors K10's wrapper hands the C entry q, k, v and dO as
    they lie (H = heads * head_dim) at the widths bwd_reads_in_place names,
    with no pad copy, and gradients at the true width; elsewhere the four
    padded to the built width (H = heads * 32 or 64) and the gradients cut
    back. The entry's head_dim is always the true one."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, s, heads * head_dim, **meta)
    bias = torch.zeros(2, s, device="meta")
    calls, pads = _capture_launches(monkeypatch, fa)
    grads = fa.flash_attention_bwd(q, q, q, bias, q, num_heads=heads)
    assert [g.shape for g in grads] == [q.shape] * 3
    (_, entry, _, *args), = calls
    width = built_head_dim(head_dim, fa.BWD_HEAD_DIMS)
    assert entry == "frag_flash_attention_bwd"
    assert args[9:] == [2, s, heads * (head_dim if in_place else width), heads, head_dim]
    assert pads == ([] if in_place else [width] * 4)


@pytest.mark.parametrize("d,hq,hkv,dtype,in_place", [
    (100, 32, 32, torch.bfloat16, True), (80, 32, 32, torch.bfloat16, True),
    (96, 12, 2, torch.bfloat16, True), (64, 14, 2, torch.bfloat16, True),
    (128, 32, 8, torch.bfloat16, True), (52, 8, 8, torch.bfloat16, False),
    (100, 32, 32, torch.float32, True), (100, 4, 2, torch.float32, True),
    (100, 4, 2, torch.bfloat16, False), (25, 4, 4, torch.bfloat16, False),
    (126, 4, 4, torch.bfloat16, False), (25, 4, 4, torch.float32, False)])
def test_k9_wrapper_passes_heads_in_place(monkeypatch, d, hq, hkv, dtype, in_place):
    """On device tensors K9's wrapper hands the C entry q, k and v as they
    lie (a head's columns D = head_dim) at the widths causal_reads_in_place
    names, with no pad copy and an output at the true width; elsewhere the
    three padded to the built width (D = 64 or 128) and the output cut
    back. The entry's head_dim is always the true one."""
    s = 96
    q = torch.empty(1, s, hq * d, device="meta", dtype=dtype)
    kv = torch.empty(1, s, hkv * d, device="meta", dtype=dtype)
    pad = torch.zeros(1, dtype=torch.int32, device="meta")
    calls, pads = _capture_launches(monkeypatch, k9)
    out = k9.causal_flash_prefill(q, kv, kv, pad, num_q_heads=hq, num_kv_heads=hkv)
    assert out.shape == q.shape
    (_, entry, _, *args), = calls
    width = built_head_dim(d, k9.KERNEL_HEAD_DIMS)
    assert entry == "frag_causal_flash"
    assert args[5:] == [1, s, hq, hkv, d if in_place else width,
                        1 if dtype == torch.bfloat16 else 0, d]
    assert pads == ([] if in_place else [width] * 3)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,head_dim,heads,route", [
    ("K2", 26, 12, "in place"), ("K2", 30, 12, "copy"), ("K10", 16, 12, "in place"),
    ("K10", 26, 12, "in place"), ("K10", 26, 6, "copy"), ("K9", 100, 32, "in place"),
    ("K9", 80, 32, "in place"), ("K9", 52, 8, "copy")])
def test_chip_smoke_reads_each_generic_route_from_the_launch_counts(monkeypatch, kernel, head_dim,
                                                                    heads, route):
    """chip_smoke names a generic case's route from its kernel's count of
    launches on heads read where they lie, read around every wrapper call
    (``RoutedRun``), not from the rule: through the real wrappers (the
    launch captured, meta tensors) every call of a width the rule reads in
    place counts (``in place``), none of a padded one does (``copy``), and
    the rule's route is the one expected. A count that moves on some calls
    only reads ``mixed``, and a count that never moves ``copy``, whatever
    the rule says: each would fail the case on the card."""
    smoke = _chip_smoke()
    meta = dict(device="meta", dtype=torch.bfloat16)
    s = 64
    _capture_launches(monkeypatch, fa if kernel != "K9" else k9)
    bias = torch.zeros(2, s, device="meta")
    if kernel == "K9":
        q = torch.empty(1, s, heads * head_dim, **meta)
        pad = torch.zeros(1, dtype=torch.int32, device="meta")
        run = lambda: k9.causal_flash_prefill(q, q, q, pad, num_q_heads=heads,   # noqa: E731
                                              num_kv_heads=heads)
        count = lambda: k9.IN_PLACE_LAUNCHES[head_dim]   # noqa: E731
        rule = k9.causal_reads_in_place(head_dim, heads, heads, torch.bfloat16)
    else:
        q = torch.empty(2, s, heads * head_dim, **meta)
        if kernel == "K2":
            run = lambda: fa.flash_attention(q, q, q, bias, num_heads=heads)   # noqa: E731
            count = lambda: fa.FWD_IN_PLACE_LAUNCHES   # noqa: E731
            rule = fa.fwd_reads_in_place(head_dim, s, heads * head_dim)
        else:
            run = lambda: fa.flash_attention_bwd(q, q, q, bias, q, num_heads=heads)   # noqa: E731
            count = lambda: fa.BWD_IN_PLACE_LAUNCHES   # noqa: E731
            rule = fa.bwd_reads_in_place(head_dim, heads * head_dim)
    (name, shape, routed, plain), = smoke.routed([("k", "shape", run, None)], count,
                                                  lambda shape: rule)
    for _ in range(3):
        routed()
    assert (routed.calls, routed.route, routed.expected) == (3, route, route)
    flips = iter([0, 1, 1, 1])
    mixed = smoke.RoutedRun(lambda: None, lambda: next(flips), "in place")
    mixed(), mixed()
    assert mixed.route == "mixed"
    still = smoke.RoutedRun(lambda: None, lambda: 0, "in place")
    still()
    assert still.route == "copy" != still.expected


def test_pad_heads_round_trips_and_leaves_built_widths_alone():
    x = torch.randn(2, 5, 12 * 26)
    p = pad_heads(x, 12, 32)
    assert p.shape == (2, 5, 384) and torch.equal(unpad_heads(p, 12, 26), x)
    y = torch.randn(2, 5, 8 * 64)
    assert pad_heads(y, 8, 64) is y and unpad_heads(y, 8, 64) is y
    assert [built_head_dim(d, (32, 64)) for d in (1, 26, 32, 33, 64, 65)] == [32, 32, 32, 64, 64,
                                                                              None]
    assert [built_head_dim(d, (64, 128)) for d in (80, 96, 100, 128, 160)] == [128] * 4 + [None]


# --------------------------------------------------------------------- K3


def _gelu_gap() -> float:
    v = np.linspace(-12, 12, 480001)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=False), np.float64)
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(v, jnp.float32), approximate=True), np.float64)
    return float(np.abs(exact - tanh).max())


@pytest.mark.parametrize("h,i", [(312, 1200), (128, 512), (512, 2048)])
def test_fused_ffn_plain_vs_pallas_at_generic_widths_within_gelu_gap(h, i):
    """TinyBERT-L-4's, TinyBERT-L-2's and BERT-Small's FFN at 129 tokens:
    the TPU kernel's tanh GELU against the port's erf GELU, each output
    within gap * ||W2[:, j]||_1 (+ f32 summation noise), the bar of the
    384, 768 and 1,024 tests."""
    rng = np.random.default_rng(h)
    n = 129
    x = rng.standard_normal((n, h)).astype(np.float32)
    w1 = (rng.standard_normal((h, i)) / np.sqrt(h)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(i)).astype(np.float32)
    w2 = (rng.standard_normal((i, h)) / np.sqrt(i)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    ref = np.asarray(jax_fused_ffn(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                                   interpret=True))
    out = ffn.fused_ffn_plain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2))).numpy()
    bound = _gelu_gap() * np.abs(w2).sum(axis=0) + 1e-4
    assert out.shape == (n, h)
    assert np.all(np.abs(out - ref) <= bound[None, :])
    assert np.abs(out - ref).max() > 1e-6


@pytest.mark.parametrize("h,i,route", [(384, 1536, "fused"), (768, 3072, "fused"),
                                       (1024, 4096, "large"), (312, 1200, "generic"),
                                       (128, 512, "generic"), (512, 2048, "generic"),
                                       (1024, 4000, "generic"), (2048, 8192, "generic"),
                                       (384, 1000, "generic"), (100, 400, None),
                                       (2044, 8176, None), (512, 2044, None)])
def test_k3_routes(h, i, route):
    """The tuned designs keep their widths (384 and 768 with I whole
    chunks, 1,024 with I whole 64-steps); every other H and I that are
    multiples of 8 take the generic route; rows that are not whole 16-byte
    chunks take none."""
    assert ffn.kernel_route(h, i) == route
    assert ffn.kernel_takes(h, i) == (route is not None)


GENERIC_SHAPES = [(h, i, n) for h, i in ((128, 512), (312, 1200), (512, 2048), (1024, 4000),
                                         (2048, 8192))
                  for n in (1, 512, 999, 32768)]


def _split_steps(steps: int, splits: int):
    """The k steps each split of K3's second product walks, as
    csrc/fused_ffn.cu's ffn_large_kernel ranges them: split s walks
    ``range(s * steps // splits, (s + 1) * steps // splits)``."""
    return [range(s * steps // splits, (s + 1) * steps // splits) for s in range(splits)]


@pytest.mark.parametrize("h,i,n", GENERIC_SHAPES)
def test_k3_generic_plan_covers_every_tile(h, i, n):
    """On 132 SMs the generic plan's tiles cover every token tile and output
    column of both products, the splits' ranges of the ceil(I / 64) k steps
    cover each step once, in order, with at least 4 a split, the split grid
    stays in one wave, and a 256-column tile leaves no more columns idle
    than a 128-column one would. 64-column tiles are taken where their grid
    fits one wave: at (128, 512) and 512 tokens, 4 token tiles by 2 output
    column tiles of the second product."""
    up_cols, down_cols, splits = ffn.large_launch_plan(n, i, H100_SMS, h)
    tiles, steps = -(-n // 128), -(-i // 64)
    assert up_cols in (64, 128, 256) and down_cols in (64, 128, 256)
    for cols, width in ((up_cols, i), (down_cols, h)):
        assert -(-width // cols) * cols >= width > (-(-width // cols) - 1) * cols
        if cols == 256:
            assert ffn.wide_tiles_fit(width)
        if cols == 64:
            assert tiles * -(-width // 64) <= H100_SMS
    ranges = _split_steps(steps, splits)
    assert [k for r in ranges for k in r] == list(range(steps))
    if splits > 1:
        assert min(len(r) for r in ranges) >= ffn.LARGE_MIN_STEPS
        assert tiles * -(-h // down_cols) * splits <= H100_SMS
    if (h, n) == (128, 512):
        assert down_cols == 64 and -(-h // down_cols) == 2
    assert ffn.launch_plan(n, h, i, H100_SMS) == (128, 64, splits)


def _old_large_plan(n: int, i_dim: int, sms: int, h_dim: int = 1024):
    """The 1,024 design's plan as it stood before the generic route split
    any step count: 128- or 256-column tiles, a split that divides the k
    steps."""
    tiles = -(-n // 128)
    up_cols = (128 if not ffn.wide_tiles_fit(i_dim) or tiles * -(-i_dim // 128) <= sms else 256)
    if ffn.wide_tiles_fit(h_dim) and tiles * -(-h_dim // 256) >= sms:
        return up_cols, 256, 1
    units, steps = tiles * -(-h_dim // 128), -(-i_dim // 64)
    splits = max([d for d in range(1, steps // 4 + 1) if steps % d == 0 and units * d <= sms]
                 or [1])
    return up_cols, 128, splits


@pytest.mark.parametrize("i_dim", [4096, 2048, 1024, 8192])
def test_k3_large_route_plans_are_unchanged(i_dim):
    """The hidden-1,024 design ("large" route) keeps its plans at every
    token count: a split that divides the k steps (the same ranges as
    before), 128- or 256-column tiles; 512 tokens (128, 128, 4) and 34,816
    (256, 256, 1) at I = 4,096. Its split ranges are the even ones."""
    assert ffn.kernel_route(1024, i_dim) == "large"
    for n in (1, 63, 129, 257, 300, 512, 640, 999, 1025, 2048, 4096, 17030, 34816, 131072):
        plan = ffn.large_launch_plan(n, i_dim, H100_SMS)
        assert plan == _old_large_plan(n, i_dim, H100_SMS), n
        steps = i_dim // 64
        assert all(len(r) == steps // plan[2] for r in _split_steps(steps, plan[2]))
    if i_dim == 4096:
        assert ffn.large_launch_plan(512, 4096, H100_SMS) == (128, 128, 4)
        assert ffn.large_launch_plan(34816, 4096, H100_SMS) == (256, 256, 1)


@pytest.mark.parametrize("steps,splits", [(19, 4), (19, 3), (63, 15), (64, 4), (5, 1), (32, 8)])
def test_k3_split_ranges_cover_each_step_once(steps, splits):
    """The kernel's split ranges (split s walks s * steps //
    splits .. (s + 1) * steps // splits - 1): consecutive, each k step
    once, lengths differing by at most one; where the split divides the
    steps, every range is steps / splits long."""
    ranges = _split_steps(steps, splits)
    assert [k for r in ranges for k in r] == list(range(steps))
    lengths = [len(r) for r in ranges]
    assert max(lengths) - min(lengths) <= 1 and min(lengths) >= steps // splits
    if steps % splits == 0:
        assert set(lengths) == {steps // splits}


@pytest.mark.parametrize("h,i,n", [(312, 1200, 32768), (512, 2048, 512), (128, 512, 1)])
def test_k3_generic_scratch_bytes(h, i, n):
    """The generic route's device scratch: h [N, I] bf16 and, where the
    second product is split, its [splits, N, H] f32 partials."""
    splits = ffn.large_launch_plan(n, i, H100_SMS, h)[2]
    want = n * i * 2 + (splits * n * h * 4 if splits > 1 else 0)
    assert ffn.large_scratch_bytes(n, i, splits, h) == want


def test_k3_generic_granule_mirrors_the_cuda_check():
    """ops/fused_ffn.py's GENERIC_GRANULE is csrc/fused_ffn.cu's kGGranule
    (the C entry refuses H or I that is not a multiple of it): 8 bf16
    elements, one 16-byte chunk, the TMA's row granule; the k steps and
    tile widths the plan assumes are the CUDA constants."""
    import re
    from pathlib import Path

    src = (Path(ffn.__file__).resolve().parents[1] / "csrc" / "fused_ffn.cu").read_text()
    consts = dict(re.findall(r"^constexpr int (kG\w+) = (\d+);", src, re.M))
    assert int(consts["kGGranule"]) == ffn.GENERIC_GRANULE == 8
    assert ffn.GENERIC_GRANULE * 2 == 16
    assert (int(consts["kGDepth"]), int(consts["kGTokens"])) == (ffn.LARGE_DEPTH, ffn.LARGE_TOKENS)
    assert (int(consts["kGWideCols"]), int(consts["kGNarrowCols"])) == (ffn.LARGE_WIDE_COLS,
                                                                        ffn.LARGE_NARROW_COLS)
    assert int(consts["kGSlimCols"]) == ffn.LARGE_SLIM_COLS == 64
    assert int(consts["kGMinSteps"]) == ffn.LARGE_MIN_STEPS


@pytest.mark.parametrize("cols", [256, 128, 64])
def test_k3_generic_ring_fits_shared_memory(cols):
    """The generic route runs the 1,024 design's blocks: their ring, the
    staging tiles, the alignment slack and the barriers fit the 227 KB a
    block may take, at either tile width, whatever H and I are."""
    stages = ffn.LARGE_WIDE_STAGES if cols == 256 else ffn.LARGE_NARROW_STAGES
    assert ffn.large_smem_bytes(cols) + 2 * stages * 8 <= topk.SMEM_BLOCK_LIMIT


# --------------------------------------------------------------------- K9

K9_CASES = [(hq, hkv, d) for d in (80, 96, 100) for hq, hkv in ((4, 2), (2, 2))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,d", K9_CASES)
def test_k9_plain_matches_pallas_at_odd_head_dims(hq, hkv, d, dtype):
    """K9's plain version against the Pallas kernel (interpret mode, blocks
    of 128) at head_dim 80, 96 and 100 (open_llama_3b_v2), GQA groups 2
    and 1, S = 256 with left pads 0 and 37: real rows within 1e-5 (f32) or
    3e-2 (bf16), padding rows zero in the port."""
    b, s, pads = 2, 256, (0, 37)
    rng = np.random.default_rng(d + hq)
    q = rng.standard_normal((b, s, hq * d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv * d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv * d)).astype(np.float32)
    pad = np.asarray(pads, np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    got = _np(k9.causal_flash_prefill(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                      torch.from_numpy(pad), num_q_heads=hq, num_kv_heads=hkv))
    want = _np(jax_causal_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(pad),
                                num_q_heads=hq, num_kv_heads=hkv, block_q=128, block_k=128,
                                interpret=True))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for row, p in enumerate(pads):
        np.testing.assert_allclose(got[row, p:], want[row, p:], atol=tol, rtol=0)
        assert (got[row, :p] == 0).all()


@pytest.mark.parametrize("d", [80, 100])
def test_k9_padded_heads_compute_the_same_attention(d):
    """K9's padded route on the CPU: q, k and v zero-padded to 128 a head,
    the scale from the true head_dim, the padded columns dropped, give the
    unpadded plain version within f32 rounding; the padded output columns
    are exactly zero."""
    b, s, hq, hkv = 2, 70, 4, 2
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n * d)).astype(np.float32))
               for n in (hq, hkv, hkv))
    pad = torch.tensor([0, 9], dtype=torch.int32)
    want = k9.causal_flash_prefill_plain(q, k, v, pad, num_q_heads=hq, num_kv_heads=hkv)
    qp = pad_heads(q, hq, 128) * (128 / d) ** 0.5
    kp, vp = pad_heads(k, hkv, 128), pad_heads(v, hkv, 128)
    padded = k9.causal_flash_prefill_plain(qp, kp, vp, pad, num_q_heads=hq, num_kv_heads=hkv)
    assert (padded.view(b, s, hq, 128)[..., d:] == 0).all()
    torch.testing.assert_close(unpad_heads(padded, hq, d), want, atol=1e-5, rtol=0)


# ------------------------------------------------------- the width checks


def _encoder_dir(root, name, hidden, heads, inter, classifier=False):
    d = root / name
    d.mkdir()
    raw = {"hidden_size": hidden, "num_hidden_layers": 4, "num_attention_heads": heads,
           "intermediate_size": inter, "vocab_size": 30522, "max_position_embeddings": 512}
    if classifier:
        raw.update(architectures=["BertForSequenceClassification"], id2label={"0": "LABEL_0"})
    (d / "config.json").write_text(json.dumps(raw))
    return str(d)


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_cuda_takes_the_published_narrow_checkpoints(tmp_path, kind):
    """check_supported on CUDA takes BERT-Small-width encoders (and the
    TinyBERT-L-2 width as gte) beside a TinyBERT-L-4-width reranker, and an
    open_llama_3b_v2-width local LLM (32 heads of 100)."""
    cfg = FrameworkConfig()
    cfg.encoders.baai_path = _encoder_dir(tmp_path, "small", *BERT_SMALL)
    cfg.encoders.gte_path = _encoder_dir(tmp_path, "l2", *TINYBERT_L2)
    cfg.rerank.model_path = _encoder_dir(tmp_path, "l4", *TINYBERT_L4, classifier=True)
    llm = tmp_path / "llama"
    llm.mkdir()
    (llm / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": 32000, "num_hidden_layers": 26,
        "hidden_size": 3200, "num_attention_heads": 32, "num_key_value_heads": 32,
        "intermediate_size": 8640, "tie_word_embeddings": False}))
    cfg.llm.provider, cfg.llm.local_checkpoint = "local", str(llm)
    cfg.index.kind = kind
    check_supported(cfg, torch.device("cuda"))
    cfg.encoders.baai_path = _encoder_dir(tmp_path, "l4_enc", *TINYBERT_L4)
    check_supported(cfg, torch.device("cuda"))


@pytest.mark.parametrize("hidden,heads,inter", [TINYBERT_L4, TINYBERT_L2, BERT_SMALL])
def test_training_on_cuda_takes_the_narrow_widths(hidden, heads, inter):
    """A training step at TinyBERT-L-4's heads of 26 (K10 padded to 32) and
    at the other narrow widths passes the check; heads of 80 do not."""
    cfg = ModelConfig(hidden_size=hidden, num_layers=1, num_heads=heads,
                      intermediate_size=inter, vocab_size=64, max_position=32)
    contrastive.check_train_widths(cfg, torch.device("cuda"))
    wide = ModelConfig(hidden_size=960, num_layers=1, num_heads=12, intermediate_size=3840,
                       vocab_size=64, max_position=32)
    with pytest.raises(NotImplementedError, match=r"head_dim 80, but the attention backward "
                                                  r"\(K10\) takes head_dim <= 64"):
        contrastive.check_train_widths(wide, torch.device("cuda"))


def test_cuda_wrappers_refuse_above_the_limits():
    """On non-CPU tensors: K2 and K10 refuse heads of 80, K9 heads of 160,
    K3 hidden 100; no launch is counted."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.LAUNCHES, k9.LAUNCHES)
    x = torch.empty(2, 65, 4 * 80, **meta)
    bias = torch.zeros(2, 65, device="meta")
    with pytest.raises(ValueError, match=r"\(K2\) takes head_dim <= 64"):
        fa.flash_attention(x, x, x, bias, num_heads=4)
    with pytest.raises(ValueError, match=r"\(K10\) takes head_dim <= 64"):
        fa.flash_attention_bwd(x, x, x, bias, x, num_heads=4)
    q = torch.empty(1, 64, 4 * 160, **meta)
    kv = torch.empty(1, 64, 2 * 160, **meta)
    with pytest.raises(ValueError, match=r"\(K9\) takes head_dim <= 128"):
        k9.causal_flash_prefill(q, kv, kv, torch.zeros(1, dtype=torch.int32, device="meta"),
                                num_q_heads=4, num_kv_heads=2)
    x = torch.empty(8, 100, **meta)
    w1, w2 = torch.empty(100, 400, **meta), torch.empty(400, 100, **meta)
    with pytest.raises(ValueError, match=r"\(K3\) takes H and I multiples of 8"):
        ffn.fused_ffn(x, w1, torch.empty(400, **meta), w2, torch.empty(100, **meta))
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES, ffn.LAUNCHES, k9.LAUNCHES) == before


# ----------------------------------------------------------------- models


def _tree_np(params):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in params.items()}


def _configs(hidden, heads, inter, layers, **extra):
    shape = dict(hidden_size=hidden, num_layers=layers, num_heads=heads,
                 intermediate_size=inter, vocab_size=1000, max_position=128)
    return JaxModelConfig(**shape, **extra), ModelConfig(**shape, **extra)


def _batch(seed=0, b=4, s=48):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1000, size=(b, s)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((b, s), np.int32)
    mask[1, 17:] = 0
    mask[3, 30:] = 0
    types = np.zeros((b, s), np.int32)
    types[:, 24:] = 1
    return ids, mask, types


def test_cross_encoder_at_tinybert_l4_width_matches_jax():
    """A 2-layer cross-encoder at ms-marco-TinyBERT-L-4's width (312, 12
    heads of 26, FFN 1,200): logits within 5e-3 of the JAX package's."""
    jcfg, tcfg = _configs(*TINYBERT_L4, layers=2, num_labels=1)
    jp = jckpt.random_params(jcfg, seed=21)
    tp = checkpoint.params_from_numpy(_tree_np(jp))
    ids, mask, types = _batch(seed=3)
    ref = np.asarray(jbert.cross_encoder_forward(jp, jnp.asarray(ids), jnp.asarray(mask),
                                                 jnp.asarray(types), config=jcfg))
    out = bert.cross_encoder_forward(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                                     torch.from_numpy(types), config=tcfg).numpy()
    assert out.shape == ref.shape == (4,)
    np.testing.assert_allclose(out, ref, atol=5e-3)


@pytest.mark.parametrize("shape", [BERT_SMALL, TINYBERT_L2, TINYBERT_L4],
                         ids=["bert_small", "tinybert_l2", "tinybert_l4"])
@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_bi_encoder_at_narrow_widths_matches_jax(shape, pooling):
    """2-layer bi-encoders at BERT-Small's width (512, 8 heads of 64, FFN
    2,048) and the TinyBERT widths: unit embeddings with cosine > 0.9999
    to the JAX package's."""
    jcfg, tcfg = _configs(*shape, layers=2)
    jp = jckpt.random_params(jcfg, seed=22)
    tp = checkpoint.params_from_numpy(_tree_np(jp))
    ids, mask, _ = _batch(seed=4)
    ref = np.asarray(jbert.bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask), config=jcfg,
                                       pooling=pooling, attention_impl="xla"))
    out = bert.bert_encode(bert.prepare_params(tp, device="cpu", compute_dtype=torch.float32),
                           torch.from_numpy(ids), torch.from_numpy(mask), config=tcfg,
                           pooling=pooling).numpy()
    assert out.shape == ref.shape == (4, shape[0])
    cos = (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() > 0.9999
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


# open_llama_3b_v2's head shape (32 heads of 100, MHA, untied, no biases)
# narrowed to 4 heads of 100 with a grouping of 2
LLAMA_D100 = dict(vocab_size=211, hidden_size=400, intermediate_size=256, num_layers=2,
                  num_heads=4, num_kv_heads=2, rope_theta=10000.0, norm_eps=1e-6,
                  attention_bias=False, tie_embeddings=False, eos_token_id=5)


@pytest.mark.parametrize("pads", [(0, 3), (5, 0)])
def test_decoder_at_heads_of_100_generates_the_jax_tokens(pads):
    """A 2-layer decoder with 4 heads of 100 over 2 kv heads: the prefill
    through K9's plain version and the decode give the JAX package's
    greedy tokens exactly, and the prefill's logits within 1e-5."""
    jcfg = jdec.DecoderConfig(**LLAMA_D100)
    jp = jdec.random_decoder_params(jcfg, seed=31)
    tcfg = tdec.DecoderConfig(**LLAMA_D100)
    tp = tdec.decoder_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tcfg.head_dim == 100
    rng = np.random.default_rng(sum(pads))
    ids = rng.integers(1, 211, (2, 12)).astype(np.int32)
    am = np.ones((2, 12), np.int32)
    for row, p in enumerate(pads):
        ids[row, :p], am[row, :p] = 0, 0
    want = np.asarray(jdec.generate_tokens(jp, jnp.asarray(ids), jnp.asarray(am),
                                           jax.random.PRNGKey(0), cfg=jcfg, max_new_tokens=12))
    got = tdec.generate_tokens(tp, ids, am, cfg=tcfg, max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)
    real = am.astype(bool)
    ref = np.asarray(jdec.decoder_forward(jp, jnp.asarray(ids), jcfg, jnp.asarray(am)))
    np.testing.assert_allclose(tdec.decoder_forward(tp, ids, tcfg, am).numpy()[real], ref[real],
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------- converters


def _hf_bert_state_dict(cfg: ModelConfig, seed: int):
    """A random HF BertForSequenceClassification state dict (torch Linear
    layout)."""
    rng = np.random.default_rng(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sd = {
        "bert.embeddings.word_embeddings.weight": r(cfg.vocab_size, h),
        "bert.embeddings.position_embeddings.weight": r(cfg.max_position, h),
        "bert.embeddings.token_type_embeddings.weight": r(2, h),
        "bert.embeddings.LayerNorm.weight": r(h), "bert.embeddings.LayerNorm.bias": r(h),
        "bert.pooler.dense.weight": r(h, h), "bert.pooler.dense.bias": r(h),
        "classifier.weight": r(1, h), "classifier.bias": r(1),
    }
    for layer in range(cfg.num_layers):
        p = f"bert.encoder.layer.{layer}."
        for name, shape in [("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (i, h)), ("output.dense", (h, i))]:
            sd[p + name + ".weight"] = r(*shape)
            sd[p + name + ".bias"] = r(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = r(h)
            sd[p + ln + ".bias"] = r(h)
    return sd


@pytest.mark.parametrize("shape", [TINYBERT_L4, TINYBERT_L2, BERT_SMALL],
                         ids=["tinybert_l4", "tinybert_l2", "bert_small"])
def test_bert_converter_at_narrow_widths_matches_jax(tmp_path, shape):
    """A 1-layer HF cross-encoder checkpoint (safetensors) at each narrow
    width: the port's loader gives the JAX loader's tree, leaf for leaf."""
    from safetensors.numpy import save_file

    hidden, heads, inter = shape
    _, tcfg = _configs(hidden, heads, inter, layers=1)
    (tmp_path / "config.json").write_text(json.dumps({
        "hidden_size": hidden, "num_hidden_layers": 1, "num_attention_heads": heads,
        "intermediate_size": inter, "vocab_size": 1000, "max_position_embeddings": 128,
        "type_vocab_size": 2, "layer_norm_eps": 1e-12,
        "architectures": ["BertForSequenceClassification"], "id2label": {"0": "LABEL_0"}}))
    save_file(_hf_bert_state_dict(tcfg, seed=hidden), str(tmp_path / "model.safetensors"))
    jp, jcfg = jckpt.load_params(tmp_path)
    tp, cfg = checkpoint.load_params(tmp_path)
    assert (cfg.hidden_size, cfg.num_heads, cfg.intermediate_size) == shape
    assert (jcfg.hidden_size, jcfg.num_heads, jcfg.intermediate_size) == shape
    ref = _tree_np(jp)
    assert tp.keys() == ref.keys()
    for group in ref:
        assert tp[group].keys() == ref[group].keys()
        for name in ref[group]:
            np.testing.assert_array_equal(tp[group][name].numpy(), ref[group][name])


def test_llama_converter_at_heads_of_100_matches_jax():
    """An HF LlamaForCausalLM state dict at open_llama_3b_v2's head width
    (4 heads of 100, untied): the port's converter gives the JAX
    converter's params, and its logits match the HF model's."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=211, hidden_size=400, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False, eos_token_id=5,
        architectures=["LlamaForCausalLM"])
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    sd = model.state_dict()
    jcfg = jdec.DecoderConfig.from_hf_config(hf_cfg.to_dict())
    tcfg = tdec.DecoderConfig.from_hf_config(hf_cfg.to_dict())
    assert tcfg.__dict__ == jcfg.__dict__ and tcfg.head_dim == 100
    jp = jdec.decoder_params_from_torch_state_dict(sd, jcfg)
    tp = tdec.decoder_params_from_torch_state_dict(sd, tcfg, device="cpu")
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(), np.asarray(jp["lm_head"]))
    for name, stacked in jp["layers"].items():
        np.testing.assert_array_equal(np.stack([lp[name].numpy() for lp in tp["layers"]]),
                                      np.asarray(stacked), err_msg=name)
    ids = np.random.default_rng(0).integers(1, 211, (2, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(tdec.decoder_forward(tp, ids, tcfg).numpy(), ref,
                               atol=2e-4, rtol=2e-3)
