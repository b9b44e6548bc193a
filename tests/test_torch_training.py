"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs go through both packages: the attention backward's
plain version against the Pallas kernel's VJP in interpret mode, the FFN
Function's gradients against JAX's, the losses, one train step's loss and
per-leaf gradients against ``jax.value_and_grad`` of the JAX loss on the
XLA path (erf GELU, the same math as the port's plain path), AdamW against
``optax.adamw``, the host-side data code, a small retrieval uplift, and
checkpoints written by one package and read by the other. Every tolerance
is stated beside its check.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from financial_rag_tpu.config import ModelConfig as JaxModelConfig
from financial_rag_tpu.models.bert import bert_encode as jax_bert_encode
from financial_rag_tpu.models.bert import cross_encoder_forward as jax_cross_encoder_forward
from financial_rag_tpu.models.checkpoint import random_params as jax_random_params
from financial_rag_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from financial_rag_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from financial_rag_tpu.retrieval.rerank import CrossEncoderModel as JaxCrossEncoderModel
from financial_rag_tpu.store.feedback_db import FeedbackDatabase as JaxFeedbackDatabase
from financial_rag_tpu.tokenizer import WordPieceTokenizer as JaxWordPieceTokenizer
from financial_rag_tpu.training import contrastive as jax_contrastive
from financial_rag_tpu.training import data as jax_data
from financial_rag_tpu.training import rerank_ft as jax_rerank_ft
from financial_rag_tpu.training import uplift as jax_uplift
from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.models import bert
from financial_rag_tpu_torch.models.checkpoint import params_from_numpy, random_params
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.ops import fused_ffn as ffn
from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.ops import pool_norm as pn
from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderModel
from financial_rag_tpu_torch.store.feedback_db import FeedbackDatabase
from financial_rag_tpu_torch.tokenizer import WordPieceTokenizer
from financial_rag_tpu_torch.training import contrastive, data, rerank_ft, uplift
from financial_rag_tpu_torch.training import (make_rerank_train_step, make_train_step)

torch.set_num_threads(2)

TINY = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=512,
            vocab_size=1000, max_position=64)


def _cfgs(**kw):
    """The same small configuration in both packages (4 heads of 32 unless
    ``num_heads`` says otherwise)."""
    fields = dict(name="tiny", **{**TINY, **kw})
    return ModelConfig(**fields), JaxModelConfig(**fields)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _assert_leafwise_close(got, want, rtol: float, what: str, *, atol: float = 0.0):
    """Every leaf within rtol of the largest |value| of its JAX counterpart,
    plus atol."""
    for group in want:
        for name in want[group]:
            g, w = _np(got[group][name]), _np(want[group][name])
            assert g.shape == w.shape, (what, group, name)
            err = np.abs(g - w).max()
            assert err <= rtol * np.abs(w).max() + atol, (what, group, name, err)


def _grad_atol(grads) -> float:
    """1e-6 of the largest gradient anywhere in the tree: the floor for the
    leaves whose gradient is zero up to rounding (k_b: softmax ignores a
    shift of every key's score; the listwise loss ignores the classifier
    bias; the contrastive loss never reaches the pooler)."""
    return 1e-6 * max(float(np.abs(_np(t)).max()) for leaves in grads.values()
                      for t in leaves.values())


# ------------------------------------------------------------- K10's oracle


def _attn_inputs(seed: int, b=3, s=48, h=128):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[1, 29:] = 0      # padded keys
    mask[2] = 0           # every key masked: the uniform P
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    return q, k, v, do, bias


@pytest.mark.parametrize("heads,s", [(4, 48), (2, 64), (2, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_plain_matches_pallas_vjp(dtype, heads, s):
    """flash_attention_bwd_plain against jax.vjp of the Pallas kernel
    (_flash_bwd, interpret mode) at 4 heads of 32, S = 48 (not a multiple
    of any tile), and at 2 heads of 64 (the bge-base head width), S = 64
    and a ragged S = 37; padded keys and one fully masked row. f32: within
    2e-5 of each gradient's largest value (the sums run in another order).
    bf16: both round P^T and dS to bf16 at the same points, so the same
    values up to a one-ulp flip of a rounded element: within 2^-7 of each
    gradient's largest value. Masked keys get exact zeros in both."""
    q, k, v, do, bias = _attn_inputs(seed=1, s=s)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jbias = jnp.asarray(bias)[:, None, None, :]
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention(a, b_, c, jbias, num_heads=heads,
                                                          interpret=True), jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    got = fa.flash_attention_bwd_plain(tq, tk, tv, torch.from_numpy(bias), tdo, num_heads=heads)
    rtol = 2e-5 if dtype == "float32" else 2.0 ** -7
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == q.shape
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= rtol * np.abs(w).max(), (name, np.abs(g - w).max())
        assert (g[1, 29:] == 0).all() if name != "dq" else True
        if name != "dq":
            assert (w[1, 29:] == 0).all()


def test_flash_attention_function_is_differentiable_on_the_cpu():
    """On the CPU the Function runs the plain forward and backward: autograd
    through it gives flash_attention_bwd_plain exactly, and autograd through
    flash_attention_plain within 1e-5 of the largest gradient (f32); the
    bias gets no gradient; no launch is counted."""
    q, k, v, do, bias = _attn_inputs(seed=2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tbias = torch.from_numpy(bias).requires_grad_()
    counts = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    out = fa.flash_attention(tq, tk, tv, tbias, num_heads=4)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv, tbias), torch.from_numpy(do), allow_unused=True)
    assert got[3] is None
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == counts
    exact = fa.flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, bias, do)),
                                         num_heads=4)
    for g, e in zip(got, exact):
        assert torch.equal(g, e)
    pq, pk, pv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref = torch.autograd.grad(fa.flash_attention_plain(pq, pk, pv, torch.from_numpy(bias),
                                                       num_heads=4),
                              (pq, pk, pv), torch.from_numpy(do))
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()


def _row_rel_err(got, want, heads: int) -> float:
    """chip_smoke's K10 gate: the largest max|got - want| over one (position,
    head) row, as a share of that row's largest |want|."""
    got, want = (t.float().reshape(-1, heads, t.shape[-1] // heads) for t in (got, want))
    err = (got - want).abs().amax(dim=-1)
    return torch.where(err == 0, torch.zeros_like(err),
                       err / want.abs().amax(dim=-1).clamp_min(1e-30)).max().item()


def _bwd_with_d_from_output(q, k, v, bias, do, heads: int):
    """flash_attention_bwd_plain with FlashAttention-2's D = rowsum(dO o O)
    taken from the bf16 forward output instead of rowsum(dP o P) in f32."""
    dt, scale = q.dtype, 1.0 / ((q.shape[-1] // heads) ** 0.5)
    p = fa._probabilities(q, k, bias, heads)
    o = fa._split(fa.flash_attention_plain(q, k, v, bias, num_heads=heads), heads)
    dos = fa._split(do, heads)
    dp = dos @ fa._split(v, heads).transpose(-1, -2)
    ds = p * (dp - (dos * o).sum(dim=-1, keepdim=True))
    dq = ds.to(dt).float() @ fa._split(k, heads) * scale
    dk = ds.transpose(-1, -2).to(dt).float() @ fa._split(q, heads) * scale
    dv = p.transpose(-1, -2).to(dt).float() @ dos
    return fa._merge(dq, dt), fa._merge(dk, dt), fa._merge(dv, dt)


def test_k10_d_from_unrounded_p_holds_the_card_bound_and_d_from_the_output_does_not():
    """The D rule of K10: D = rowsum(dP o P) from the f32 P. On seeded bf16
    inputs at the contrastive head shape (12 heads of 32, S = 64, padded rows
    and a fully masked one), flash_attention_bwd_plain stays within 2^-6 of
    each (position, head) row's largest value of the JAX Pallas VJP (interpret
    mode), the bound the card holds K10 to. D from the bf16 forward output,
    the FlashAttention-2 shortcut, breaks that bound on dq, so a kernel that
    takes it cannot pass the card's gate."""
    b, s, heads = 16, 64, 12
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((b, s, heads * 32)).astype(np.float32) for _ in range(4))
    lens = rng.integers(1, s + 1, b)
    lens[0] = s
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    mask[-1] = 0
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jbias = jnp.asarray(bias)[:, None, None, :]
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention(a, b_, c, jbias, num_heads=heads,
                                                          interpret=True), jq, jk, jv)
    want = [torch.from_numpy(np.array(_np(w))) for w in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    tbias = torch.from_numpy(bias)
    rtol = 2.0 ** -6
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, tbias, tdo, num_heads=heads)
    for name, g, w in zip(("dq", "dk", "dv"), plain, want):
        assert _row_rel_err(g, w, heads) <= rtol, (name, _row_rel_err(g, w, heads))
    shortcut = _bwd_with_d_from_output(tq, tk, tv, tbias, tdo, heads)
    assert _row_rel_err(shortcut[0], want[0], heads) > rtol


def test_k10_scratch_holds_two_floats_per_query_row():
    """K10's scratch between its dQ and dK/dV kernels: each query row's
    log-sum-exp and D, [2, B, heads, S] f32 (no per-row max and sum)."""
    assert fa.bwd_scratch_shape(3, 129, 6) == (2, 3, 6, 129)
    assert fa.bwd_scratch_shape(256, 512, 12) == (2, 256, 12, 512)


def test_k10_wrapper_checks_what_the_kernel_takes():
    """flash_attention_bwd on non-CPU tensors: shapes, head width (up to
    64; 96 here) and dtype are checked before the device, and a tensor off
    CUDA raises (no fallback to the plain version); no launch is counted."""
    meta = dict(device="meta")
    x = torch.empty(2, 65, 192, dtype=torch.bfloat16, **meta)
    bias = torch.zeros(2, 65, **meta)
    before = fa.BWD_LAUNCHES
    with pytest.raises(ValueError, match="one \\[B,S,H\\] shape"):
        fa.flash_attention_bwd(x, x[:, :64], x, bias, x, num_heads=6)
    with pytest.raises(ValueError, match="head_dim <= 64 .*got H=192 over 2 heads"):
        fa.flash_attention_bwd(x, x, x, bias, x, num_heads=2)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_bwd(x, x.float(), x, bias, x, num_heads=6)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(x, x, x, bias, x, num_heads=6)
    assert fa.BWD_LAUNCHES == before


# ----------------------------------------------------------------- FFN


def _ffn_inputs(seed: int, n=40, h=64, i=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    w1 = (rng.standard_normal((h, i)) / np.sqrt(h)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(i)).astype(np.float32)
    w2 = (rng.standard_normal((i, h)) / np.sqrt(i)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    dy = rng.standard_normal((n, h)).astype(np.float32)
    return x, w1, b1, w2, b2, dy


def _port_ffn_grads(x, w1, b1, w2, b2, dy):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    out = ffn.fused_ffn(*ts)
    assert type(out.grad_fn).__name__ == "FusedFFNBackward"
    return [g.numpy() for g in torch.autograd.grad(out, ts, torch.from_numpy(dy))]


def test_fused_ffn_function_grads_match_jax_erf_ffn():
    """The Function's five gradients (f32) against jax.vjp of the JAX
    package's XLA FFN (models/bert.py, erf GELU): within 1e-5 of each
    gradient's largest value."""
    x, w1, b1, w2, b2, dy = _ffn_inputs(seed=3)

    def xla_ffn(x_, w1_, b1_, w2_, b2_):
        hh = jax.nn.gelu(jnp.dot(x_, w1_, preferred_element_type=jnp.float32) + b1_,
                         approximate=False)
        return jnp.dot(hh, w2_, preferred_element_type=jnp.float32) + b2_

    _, vjp = jax.vjp(xla_ffn, *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(dy))
    got = _port_ffn_grads(x, w1, b1, w2, b2, dy)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name


def _gelu_gaps():
    """max |gelu_tanh - gelu_erf| and max |gelu_tanh' - gelu_erf'| on a fine
    grid over [-12, 12] (outside it both are 0/identity to f32)."""
    h = jnp.linspace(-12.0, 12.0, 240001)
    val = jnp.abs(jax.nn.gelu(h, approximate=True) - jax.nn.gelu(h, approximate=False)).max()
    d_tanh = jax.vmap(jax.grad(lambda t: jax.nn.gelu(t, approximate=True)))(h)
    d_erf = jax.vmap(jax.grad(lambda t: jax.nn.gelu(t, approximate=False)))(h)
    return float(val), float(jnp.abs(d_tanh - d_erf).max())


def test_fused_ffn_function_grads_vs_pallas_vjp_within_gelu_gap():
    """Against the JAX custom VJP (tanh GELU, Pallas forward in interpret
    mode): each gradient may move only by what the GELU gap allows. With
    g = max|tanh-GELU - erf-GELU| and g' the gap of their derivatives,
    da = dy W2^T: |d dx| <= g' |da| |W1|^T, |d dW1| <= g' |x|^T |da|,
    |d db1| <= g' sum |da|, |d dW2| <= g |dy| summed over tokens, db2 is
    the same; plus 1e-5 of each gradient's largest value for f32 rounding.
    The difference must also be real: the port differentiates erf GELU."""
    x, w1, b1, w2, b2, dy = _ffn_inputs(seed=4)
    g, gd = _gelu_gaps()
    assert 1e-4 < g < 2e-3 and 1e-4 < gd < 5e-3
    _, vjp = jax.vjp(lambda *a: jax_fused_ffn(*a, interpret=True),
                     *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    got = _port_ffn_grads(x, w1, b1, w2, b2, dy)
    da = np.abs(dy @ w2.T)
    bounds = [gd * da @ np.abs(w1).T, gd * np.abs(x).T @ da, gd * da.sum(0),
              g * np.abs(dy).sum(0)[None, :].repeat(w2.shape[0], 0), np.zeros(w2.shape[1])]
    for name, gt, w, bnd in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want, bounds):
        assert np.all(np.abs(gt - w) <= bnd + 1e-5 * np.abs(w).max()), name
    assert max(np.abs(gt - w).max() for gt, w in zip(got[:4], want[:4])) > 1e-6


def test_fused_ffn_function_takes_f32_masters_and_returns_f32_weight_grads():
    """bf16 activations with f32 master weights (the train step's inputs):
    dx comes back in bf16, the weight gradients in f32, each equal to
    fused_ffn_bwd on the same inputs, and the forward equals the plain
    version on the bf16-cast weights."""
    x, w1, b1, w2, b2, dy = _ffn_inputs(seed=5)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ws = [torch.from_numpy(a).requires_grad_() for a in (w1, b1, w2, b2)]
    out = ffn.fused_ffn(tx, *ws)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ffn.fused_ffn_plain(tx.detach(), *(w.detach() for w in ws)))
    tdy = torch.from_numpy(dy).to(torch.bfloat16)
    got = torch.autograd.grad(out, (tx, *ws), tdy)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    want = ffn.fused_ffn_bwd(tx.detach(), *(w.detach() for w in ws), tdy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- losses


def test_contrastive_loss_matches_jax():
    """Symmetric InfoNCE on the same unit-norm embeddings: within 1e-6."""
    rng = np.random.default_rng(6)
    q, d = (rng.standard_normal((8, 32)).astype(np.float32) for _ in range(2))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = float(jax_contrastive.contrastive_loss(jnp.asarray(q), jnp.asarray(d), 0.05))
    got = float(contrastive.contrastive_loss(torch.from_numpy(q), torch.from_numpy(d), 0.05))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_listwise_loss_matches_optax():
    """Softmax cross-entropy over each group, candidate 0 the label (the
    JAX loss_fn's optax call): within 1e-6."""
    logits = np.random.default_rng(7).standard_normal((6, 4)).astype(np.float32) * 3
    want = float(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.zeros((6,), jnp.int32)).mean())
    got = float(rerank_ft.listwise_loss(torch.from_numpy(logits)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


# ------------------------------------------------------ one step, per leaf


def _pair_batch(seed: int, b=4, s=16, vocab=1000):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "d"):
        lens = rng.integers(3, s + 1, size=b)
        lens[0] = s
        out[f"{side}_ids"] = rng.integers(5, vocab, size=(b, s)).astype(np.int32)
        out[f"{side}_mask"] = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return out


def _group_batch(seed: int, b=2, g=3, s=16, vocab=1000):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, s + 1, size=(b, g))
    mask = (np.arange(s)[None, None, :] < lens[:, :, None]).astype(np.int32)
    types = ((np.arange(s)[None, None, :] >= (lens[:, :, None] // 2)) * mask).astype(np.int32)
    return {"ids": rng.integers(5, vocab, size=(b, g, s)).astype(np.int32),
            "mask": mask, "types": types}


def _mesh_1x1():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _jax_contrastive_loss_fn(jcfg, pooling):
    def loss_fn(params, batch):
        q = jax_bert_encode(params, batch["q_ids"], batch["q_mask"], config=jcfg,
                            pooling=pooling, compute_dtype=jnp.float32, attention_impl="xla")
        d = jax_bert_encode(params, batch["d_ids"], batch["d_mask"], config=jcfg,
                            pooling=pooling, compute_dtype=jnp.float32, attention_impl="xla")
        return jax_contrastive.contrastive_loss(q, d, 0.05)
    return loss_fn


def _jax_rerank_loss_fn(jcfg):
    def loss_fn(params, batch):
        b, g, s = batch["ids"].shape
        logits = jax_cross_encoder_forward(
            params, batch["ids"].reshape(b * g, s), batch["mask"].reshape(b * g, s),
            batch["types"].reshape(b * g, s), config=jcfg, compute_dtype=jnp.float32,
            attention_impl="xla").reshape(b, g)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.zeros((b,), jnp.int32)).mean()
    return loss_fn


@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_contrastive_step_loss_and_grads_match_jax(pooling, heads):
    """make_train_step's loss and every leaf's gradient (CPU, f32, the
    plain path) against jax.value_and_grad of the JAX step's loss on the
    XLA path, with the same seeded weights (the two random_params draw the
    same numbers) and a padded batch, at heads of 32 and of 64: loss within
    1e-5, each leaf within 2e-4 of its largest value plus 1e-6 of the
    largest gradient in the tree. The pooler, which the loss never reaches,
    gets exact zeros."""
    cfg, jcfg = _cfgs(num_heads=heads)
    params = random_params(cfg, seed=0)
    batch = _pair_batch(seed=8)
    step, init_state = make_train_step(cfg, device="cpu", pooling=pooling)
    assert step.attention_impl == "pallas"
    masters, _ = init_state(params)
    loss, grads = step.value_and_grad(masters, batch)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_random_params(jcfg, seed=0))
    jloss, jgrads = jax.value_and_grad(_jax_contrastive_loss_fn(jcfg, pooling))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5
    _assert_leafwise_close(grads, jgrads, 2e-4, "contrastive", atol=_grad_atol(jgrads))
    assert all((t == 0).all() for t in grads["pooler"].values())


@pytest.mark.parametrize("heads", [4, 2])
def test_rerank_step_loss_and_grads_match_jax(heads):
    """make_rerank_train_step against jax.value_and_grad of the JAX listwise
    loss (XLA path, f32) on [B=2, G=3, S=16] groups with segment ids and
    padding, at heads of 32 and of 64: loss within 1e-5, each leaf within
    2e-4 of its largest value."""
    cfg, jcfg = _cfgs(num_labels=1, num_heads=heads)
    params = random_params(cfg, seed=1)
    batch = _group_batch(seed=9)
    step, init_state = make_rerank_train_step(cfg, device="cpu")
    masters, _ = init_state(params)
    loss, grads = step.value_and_grad(masters, batch)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_random_params(jcfg, seed=1))
    jloss, jgrads = jax.value_and_grad(_jax_rerank_loss_fn(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5
    _assert_leafwise_close(grads, jgrads, 2e-4, "rerank", atol=_grad_atol(jgrads))


@pytest.mark.parametrize("heads", [4, 2])
@pytest.mark.parametrize("trainer", ["contrastive", "rerank"])
def test_two_steps_match_the_jax_steps(trainer, heads):
    """Two full steps of each trainer (loss, gradients, AdamW at lr 1e-3),
    at 4 heads of 32 and at 2 heads of 64 (the bge-base head width),
    against the JAX package's own step on a 1x1 mesh with the XLA
    attention: the losses within 1e-5, and each leaf's movement over the
    two steps within 1e-3 of the JAX movement's norm, plus two f32 ulps of
    the values per element (the pooler, which only the weight decay moves
    under the contrastive loss, moves by less than an ulp). (Elementwise, Adam
    divides by sqrt(v): where two steps' gradients nearly cancel, f32
    rounding moves an element by a few percent of a step; a wrong or
    missing gradient moves the norm by O(1).) Leaves whose gradient is zero
    up to rounding are left out: Adam scales that noise up to whole steps
    in either package (k_b; the classifier bias under the listwise
    loss)."""
    if trainer == "contrastive":
        cfg, jcfg = _cfgs(num_heads=heads)
        batches = [_pair_batch(seed=10), _pair_batch(seed=11)]
        step, init_state = make_train_step(cfg, device="cpu",
                                           optimizer=contrastive.adamw(1e-3))
        jstep, jinit = jax_contrastive.make_train_step(
            jcfg, _mesh_1x1(), optimizer=optax.adamw(1e-3), attention_impl="xla")
    else:
        cfg, jcfg = _cfgs(num_labels=1, num_heads=heads)
        batches = [_group_batch(seed=12), _group_batch(seed=13)]
        step, init_state = make_rerank_train_step(cfg, device="cpu",
                                                  optimizer=contrastive.adamw(1e-3))
        jstep, jinit = jax_rerank_ft.make_rerank_train_step(
            jcfg, _mesh_1x1(), optimizer=optax.adamw(1e-3), attention_impl="xla")
    start = _tree_np(random_params(cfg, seed=2))
    params, opt = init_state(random_params(cfg, seed=2))
    jparams, jopt = jinit(jax_random_params(jcfg, seed=2))
    for batch in batches:
        params, opt, loss = step(params, opt, batch)
        jparams, jopt, jloss = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        assert abs(float(loss) - float(jloss)) <= 1e-5
    for group in start:
        for name, p0 in start[group].items():
            if name == "k_b" or (group, name) == ("classifier", "b"):
                continue
            moved, jmoved = _np(params[group][name]) - p0, _np(jparams[group][name]) - p0
            ulps = 2 * np.linalg.norm(np.spacing(np.abs(p0) + 1e-3 * 2))   # f32 storage
            assert np.linalg.norm(moved - jmoved) <= 1e-3 * np.linalg.norm(jmoved) + ulps, \
                (group, name)


def test_adamw_matches_optax_adamw_and_pins_weight_decay():
    """Given the same gradients, the trainer's default optimizer
    (contrastive.adamw: torch AdamW with optax's weight decay 1e-4) equals
    optax.adamw over 3 steps within 1e-6 of each leaf's largest value (a
    few float32 ulps: the two order the decay and the bias corrections
    differently).
    torch's own default weight decay (1e-2) does not: the control."""
    rng = np.random.default_rng(14)
    shapes = [(6, 5), (5,), (3, 4, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    lr = 1e-2

    tx = optax.adamw(lr)
    jp = [jnp.asarray(a) for a in init]
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, updates)

    def run(factory):
        ps = [torch.from_numpy(a.copy()).requires_grad_() for a in init]
        opt = factory(ps)
        for g in grads:
            for p, a in zip(ps, g):
                p.grad = torch.from_numpy(a)
            opt.step()
        return [p.detach().numpy() for p in ps]

    def err(ps):
        return max(np.abs(p - np.asarray(w)).max() / np.abs(np.asarray(w)).max()
                   for p, w in zip(ps, jp))

    assert err(run(contrastive.adamw(lr))) <= 1e-6
    assert err(run(lambda ps: torch.optim.AdamW(ps, lr=lr))) > 1e-5


def test_default_optimizers_and_compute_dtype_contract():
    """The defaults match optax.adamw(1e-5) / (2e-5); f32 compute on the
    GPU is refused (K2/K10/K3 take bf16), bf16 on the CPU is allowed."""
    cfg, _ = _cfgs()
    for make, lr in ((make_train_step, 1e-5), (make_rerank_train_step, 2e-5)):
        _, init_state = make(cfg if make is make_train_step else _cfgs(num_labels=1)[0],
                             device="cpu")
        masters, opt = init_state(random_params(cfg, seed=0))
        assert isinstance(opt, torch.optim.AdamW)
        d = opt.defaults
        assert (d["lr"], d["weight_decay"], d["betas"], d["eps"]) == (lr, 1e-4, (0.9, 0.999), 1e-8)
        assert all(t.dtype == torch.float32 and t.requires_grad
                   for group in masters.values() for t in group.values())
    assert contrastive.resolve_compute_dtype(torch.device("cpu"), None) == torch.float32
    assert contrastive.resolve_compute_dtype(torch.device("cuda"), None) == torch.bfloat16
    assert contrastive.resolve_compute_dtype(torch.device("cpu"), torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        contrastive.resolve_compute_dtype(torch.device("cuda"), torch.float32)


def test_step_moves_the_parameters_in_place_and_lowers_the_loss():
    """The step updates the master tensors in place (it returns the tree
    it was given) and, at lr 1e-3 on one repeated batch, the loss falls."""
    cfg, _ = _cfgs()
    step, init_state = make_train_step(cfg, device="cpu", optimizer=contrastive.adamw(1e-3))
    params, opt = init_state(random_params(cfg, seed=3))
    before = params["layers"]["q_w"].detach().clone()
    batch = _pair_batch(seed=15)
    losses = []
    for _ in range(4):
        out, opt, loss = step(params, opt, batch)
        assert out is params
        losses.append(float(loss))
    assert (params["layers"]["q_w"] - before).abs().max() > 0
    assert losses[-1] < losses[0]


# ------------------------------------------------------------ pooling, guards


def test_pool_hidden_plain_switch_is_differentiable_and_matches_k1_plain():
    """fused_pool=False is the JAX package's XLA mean pool: equal to K1's
    plain version within 1e-6, and differentiable."""
    rng = np.random.default_rng(16)
    hidden = torch.from_numpy(rng.standard_normal((3, 10, 32)).astype(np.float32)).requires_grad_()
    mask = torch.from_numpy((np.arange(10)[None, :] < np.array([10, 4, 1])[:, None]).astype(np.int32))
    counted = pn.LAUNCHES
    out = bert.pool_hidden(hidden, mask, "mean", fused_pool=False)
    assert out.grad_fn is not None and pn.LAUNCHES == counted
    ref = pn.masked_mean_l2_normalize_plain(hidden.detach(), mask)
    assert (out.detach() - ref).abs().max() <= 1e-6
    (g,) = torch.autograd.grad(out.sum(), hidden)
    assert torch.isfinite(g).all() and (g[1, 4:] == 0).all()


def test_require_no_grad_raises_only_where_a_graph_would_be_cut():
    """The guard the kernels without a backward (K1, K4-K9) call on CUDA
    inputs: raises with grad enabled and an input that needs a gradient;
    passes under no_grad and for detached inputs."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel_lib.require_no_grad("k", torch.ones(3), x)
    with torch.no_grad():
        kernel_lib.require_no_grad("k", x)
    kernel_lib.require_no_grad("k", x.detach(), torch.ones(3))


# --------------------------------------------------------------- host code


@pytest.fixture(scope="module")
def tokenizers():
    return WordPieceTokenizer(), JaxWordPieceTokenizer()


def test_synthetic_task_and_pair_batcher_match_jax(tokenizers):
    """The same seed gives the same task and the same [B, S] batches,
    including the short last batch."""
    tok, jtok = tokenizers
    task = data.synthetic_paraphrase_task(tok, n_concepts=16, n_train=40, n_eval=12, seed=3)
    jtask = jax_data.synthetic_paraphrase_task(jtok, n_concepts=16, n_train=40, n_eval=12, seed=3)
    assert task == jtask
    got = list(data.PairBatcher(tok, max_seq_len=12).batches(task["train_pairs"], 16,
                                                             shuffle_seed=4))
    want = list(jax_data.PairBatcher(jtok, max_seq_len=12).batches(jtask["train_pairs"], 16,
                                                                   shuffle_seed=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g)


def test_pseudo_pairs_match_jax():
    texts = ["Short one.", "The lease runs for three years. Rent is due monthly on the first "
             "day and a deposit of two months is held by the lessor until the end.",
             "ok " * 20]
    assert data.pseudo_pairs_from_children(texts) == jax_data.pseudo_pairs_from_children(texts)


def _seed_feedback(db):
    results = {"good query": {"top_children_chunks": [{"text": "relevant passage one"},
                                                      {"text": "relevant passage two"}]},
               "bad query": {"top_children_chunks": [{"text": "misleading passage"}]},
               "meh query": {"top_children_chunks": [{"text": "neutral passage"}]}}
    for q, result in results.items():
        db.cache_put(f"hash-{q}", q, result)
    for q, rating in (("good query", 5), ("bad query", 1), ("meh query", 3),
                      ("expired query", 5), ("good query", None)):
        db.store_feedback(query=q, rating=rating)
    return db


def test_feedback_mining_and_groups_match_jax(tmp_path):
    """mine_feedback_triples and triples_to_groups over the same feedback
    give the same triples and groups."""
    db = _seed_feedback(FeedbackDatabase(tmp_path / "port.db"))
    jdb = _seed_feedback(JaxFeedbackDatabase(tmp_path / "jax.db"))
    triples = rerank_ft.mine_feedback_triples(db)
    assert triples == jax_rerank_ft.mine_feedback_triples(jdb) and len(triples) == 3
    for size in (2, 3):
        assert (rerank_ft.triples_to_groups(triples, group_size=size, seed=1)
                == jax_rerank_ft.triples_to_groups(triples, group_size=size, seed=1))


def test_listwise_batcher_and_task_groups_match_jax(tokenizers):
    """groups_from_task and ListwiseBatcher: the same groups and the same
    [B, G, S] ids, masks and segment ids, the repeat-padded short batch
    included."""
    tok, jtok = tokenizers
    task = data.synthetic_paraphrase_task(tok, n_concepts=16, n_train=20, n_eval=6, seed=5)
    groups = rerank_ft.groups_from_task(task, "train", group_size=3, seed=5)
    assert groups == jax_rerank_ft.groups_from_task(task, "train", group_size=3, seed=5)
    for drop in (True, False):
        got = list(rerank_ft.ListwiseBatcher(tok, max_seq_len=20).batches(
            groups[:11], 4, shuffle_seed=6, drop_remainder=drop))
        want = list(jax_rerank_ft.ListwiseBatcher(jtok, max_seq_len=20).batches(
            groups[:11], 4, shuffle_seed=6, drop_remainder=drop))
        assert len(got) == len(want) == (2 if drop else 3)
        for g, w in zip(got, want):
            assert all(np.array_equal(g[k], w[k]) for k in ("ids", "mask", "types"))


# ------------------------------------------------------- evals and uplift


def test_eval_recall_and_rank1_match_jax(tokenizers):
    """The serving-path evals of both harnesses on the same weights and
    pairs: recall@k through Encoder + FlatIndex, rank-1 accuracy through
    CrossEncoderModel.predict; equal."""
    tok, jtok = tokenizers
    cfg, jcfg = _cfgs(vocab_size=30522)
    task = data.synthetic_paraphrase_task(tok, n_concepts=16, n_train=8, n_eval=24, seed=7)
    params = random_params(cfg, seed=4)
    jparams = jax_random_params(jcfg, seed=4)
    got = uplift.eval_recall_at_k(cfg, params, tok, task["eval_pairs"], k=5, seq_len=16,
                                  device="cpu")
    want = jax_uplift.eval_recall_at_k(jcfg, jparams, jtok, task["eval_pairs"], k=5, seq_len=16)
    assert got == want
    ccfg, jccfg = _cfgs(vocab_size=30522, num_labels=1)
    groups = rerank_ft.groups_from_task(task, "eval", group_size=4, seed=8)
    got = rerank_ft.eval_rank1_accuracy(ccfg, random_params(ccfg, seed=5), tok, groups,
                                        max_seq_len=16, device="cpu")
    want = jax_rerank_ft.eval_rank1_accuracy(jccfg, jax_random_params(jccfg, seed=5), jtok,
                                             groups, max_seq_len=16)
    assert got == want


def test_small_retrieval_uplift_on_the_cpu(tokenizers):
    """measure_retrieval_uplift at the JAX package's own test sizes
    (tests/test_parallel.py: 2 layers, hidden 128, 30 steps of 48 pairs,
    24 concepts): from chance to decisive retrieval, uplift >= 0.5."""
    cfg = ModelConfig(name="tiny-uplift", hidden_size=128, num_layers=2, num_heads=4,
                      intermediate_size=256, vocab_size=30522, max_position=64)
    rep = uplift.measure_retrieval_uplift(cfg, device="cpu", steps=30, batch_size=48, lr=5e-4,
                                          seq_len=24, k=5, n_concepts=24, n_train=256,
                                          n_eval=64, seed=0, tokenizer=tokenizers[0])
    assert rep["recall_before"] <= 0.25, rep
    assert rep["recall_after"] >= 0.75, rep
    assert rep["uplift"] >= 0.5, rep
    assert rep["final_loss"] < 0.5, rep
    assert rep["device"] == "cpu" and rep["attention"] == "pallas"


def test_rerank_uplift_harness_runs_and_reports(tokenizers):
    """measure_rerank_uplift at a tiny size: the report's keys, a chance
    level of 1/G, and fine-tuned params with the classification head."""
    cfg, _ = _cfgs(vocab_size=30522, num_labels=1)
    rep, params = rerank_ft.measure_rerank_uplift(
        cfg, device="cpu", steps=3, batch_size=8, group_size=4, seq_len=16, n_concepts=16,
        n_train=24, n_eval=8, tokenizer=tokenizers[0])
    assert rep["steps"] == 3 and rep["chance"] == 0.25 and rep["device"] == "cpu"
    assert 0.0 <= rep["rank1_before"] <= 1.0 and 0.0 <= rep["rank1_after"] <= 1.0
    assert np.isfinite(rep["loss_first"]) and np.isfinite(rep["loss_last"])
    assert "classifier" in params


# ------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_finetuned_round_trips_between_packages(tmp_path, writer, tokenizers):
    """A checkpoint written by one package's save_finetuned loads in the
    other's CrossEncoderModel.from_pretrained with the same config and
    scores the same pairs within 1e-4 (both f32 on the CPU); the weights
    round-trip bit for bit."""
    tok, jtok = tokenizers
    cfg, jcfg = _cfgs(vocab_size=30522, num_labels=1)
    params = random_params(cfg, seed=6)
    params["classifier"]["b"] += 0.25   # something fine-tuning would have moved
    if writer == "port":
        out = rerank_ft.save_finetuned(params, cfg, tmp_path / "ckpt")
    else:
        out = jax_rerank_ft.save_finetuned(
            {g: {k: jnp.asarray(v.numpy()) for k, v in leaves.items()}
             for g, leaves in params.items()}, jcfg, tmp_path / "ckpt")
    assert json.loads((out / "config.json").read_text())["num_hidden_layers"] == 2
    port = CrossEncoderModel.from_pretrained(str(out), tokenizer=tok, max_seq_len=32,
                                             device="cpu")
    jmodel = JaxCrossEncoderModel.from_pretrained(str(out), tokenizer=jtok, max_seq_len=32)
    assert port.config.num_labels == jmodel.config.num_labels == 1
    assert port.config.num_layers == jmodel.config.num_layers == 2
    for group, leaves in params.items():
        for name, t in leaves.items():
            assert np.array_equal(_np(jmodel.params[group][name]), t.numpy())
    loaded = params_from_numpy(_tree_np(jmodel.params))
    assert all(torch.equal(loaded[g][k], params[g][k]) for g in params for k in params[g])
    pairs = [("what is the rent", "the rent is forty thousand"),
             ("who is the lessor", "invoice for freight charges")]
    assert np.abs(port.predict(pairs) - jmodel.predict(pairs)).max() <= 1e-4


# ----------------------------------------------------------- entry points


@pytest.mark.parametrize("script,argv", [
    ("bench_train", []),
    ("train_uplift", ["--layers", "1", "--hidden", "64", "--steps", "2", "--batch", "8",
                      "--concepts", "12", "--train", "32", "--eval", "8", "--k", "3"]),
    ("train_rerank", ["--layers", "1", "--hidden", "64", "--steps", "2", "--batch", "4",
                      "--concepts", "12", "--train", "16", "--eval", "4", "--seq", "16"]),
])
def test_entry_points_print_one_json_line_and_write_only_under_out(script, argv, tmp_path,
                                                                   capsys):
    """Each script, asked for the CPU (bench_train at its CPU size, the
    others at a tiny size), prints one JSON line naming the device, writes
    it to ``--out`` when given, and leaves the repository's
    BENCH_TRAIN.json (the JAX package's records) alone."""
    import importlib
    from pathlib import Path

    bench = Path(__file__).resolve().parent.parent / "BENCH_TRAIN.json"
    before = bench.read_bytes()
    mod = importlib.import_module(f"financial_rag_tpu_torch.scripts.{script}")
    out = tmp_path / "lines.jsonl"
    assert mod.main([*argv, "--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device_name"] == "cpu" and "metric" in line and "value" in line
    assert json.loads(out.read_text()) == line
    assert bench.read_bytes() == before


def test_train_rerank_feedback_mode_writes_a_checkpoint_the_jax_package_loads(tmp_path,
                                                                              capsys):
    """--feedback-db: triples mined from rated feedback, a few listwise
    steps, and a checkpoint directory that the JAX package's
    CrossEncoderModel loads with the fine-tuned weights."""
    from financial_rag_tpu_torch.scripts import train_rerank

    db = _seed_feedback(FeedbackDatabase(tmp_path / "fb.db"))
    db.flush_writes()
    argv = ["--feedback-db", str(tmp_path / "fb.db"), "--out-dir", str(tmp_path / "ft"),
            "--layers", "1", "--hidden", "64", "--steps", "2", "--group", "2", "--seq", "16",
            "--device", "cpu"]
    assert train_rerank.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["mode"], line["triples"], line["groups"], line["steps"]) == ("feedback", 3, 2, 2)
    model = JaxCrossEncoderModel.from_pretrained(line["checkpoint"])
    assert model.config.num_layers == 1 and model.config.hidden_size == 64


def test_kernel_ab_refuses_to_run_without_a_gpu(monkeypatch):
    """The kernel A/B script times the card only: without CUDA it exits
    before building anything."""
    from financial_rag_tpu_torch.scripts import kernel_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(kernel_ab, "build_library", lambda *a: built.append(a))
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        kernel_ab.main(["--other", "csrc"])
    assert not built
