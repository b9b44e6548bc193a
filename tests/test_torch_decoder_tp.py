"""Tensor-parallel decoder generation (models/decoder.py shard_decoder_params
/ shard_decoder_inputs) against the JAX package's GSPMD generation.

The port runs one process per rank (``parallel.launch.spawn``, gloo on the
CPU, the rank function in tests/torch_parallel_workers.py); the JAX package
runs ``generate_tokens`` on its sharded params over tests/conftest.py's 8
virtual CPU devices. Both take the same numpy weights (the JAX package's
seeded init) and prompts, in f32. Greedy tokens must be identical: between
the port's ranks, against JAX's tensor-parallel and single-device tokens, and
against the single-rank port. Each launch has a 240 s limit and each process
group a 60 s timeout.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_parallel_workers as workers
from financial_rag_tpu.models import decoder as jdec
from financial_rag_tpu_torch.models import decoder as tdec
from financial_rag_tpu_torch.parallel import launch

torch.set_num_threads(2)

# tests/test_parallel.py's decoder TP config (head_dim 8, GQA groups of 2)
TINY = dict(vocab_size=128, num_layers=2, hidden_size=32, num_heads=4, num_kv_heads=2,
            intermediate_size=64, attention_bias=True, eos_token_id=0)
NEW = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prompt(b, s, vocab, pads=(), seed=0):
    ids = np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)
    am = np.ones((b, s), np.int32)
    for row, pad in enumerate(pads):
        ids[row, :pad] = 0
        am[row, :pad] = 0
    return ids, am


def _jax_tokens(fields, jp, ids, am, dp, tp):
    """(JAX tensor-parallel tokens over a dp x tp mesh, JAX single-device)."""
    cfg = jdec.DecoderConfig(**fields)
    devices = jax.devices()
    if len(devices) < dp * tp:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    mesh = Mesh(np.array(devices[:dp * tp]).reshape(dp, tp), ("data", "model"))
    key = jax.random.PRNGKey(0)
    ref = jdec.generate_tokens(jp, jnp.asarray(ids), jnp.asarray(am), key, cfg=cfg,
                               max_new_tokens=NEW)
    got = jdec.generate_tokens(jdec.shard_decoder_params(jp, mesh, cfg),
                               *jdec.shard_decoder_inputs(jnp.asarray(ids), jnp.asarray(am),
                                                          mesh),
                               key, cfg=cfg, max_new_tokens=NEW)
    return np.asarray(got), np.asarray(ref)


def _run(cases, world, tp):
    return launch.spawn(workers.decoder_tp_generate, world,
                        args=([(f, _np(jp), ids, am, spec) for f, jp, ids, am, spec in cases],
                              tp, NEW),
                        device="cpu", timeout_s=workers.GROUP_TIMEOUT_S, join_timeout_s=240)


def _single(fields, jp, ids, am):
    return tdec.generate_tokens(tdec.decoder_params_from_numpy(_np(jp), device="cpu"),
                                ids, am, cfg=tdec.DecoderConfig(**fields),
                                max_new_tokens=NEW).numpy()


def test_dp2_tp2_generation_matches_jax_gspmd():
    """dp 2 x tp 2 on 4 gloo ranks. Cases: the JAX test's config with full
    and with left-padded prompts (vocab-split head), an untied head whose
    vocabulary (131) does not divide (replicated), and a tied head.
    Tokens: identical on every rank, to JAX's generate_tokens on
    shard_decoder_params over a 4 x 2 mesh of the 8 devices (and JAX's
    single-device tokens), and to the single-rank port; the first case's
    generate_tokens_spec under TP identical to the single-rank port's."""
    cases = []
    for fields, pads in ((TINY, ()), (TINY, (0, 3, 5, 8)),
                         (dict(TINY, vocab_size=131), (2, 0, 0, 1)),
                         (dict(TINY, tie_embeddings=True), (0, 4, 0, 0))):
        jp = jdec.random_decoder_params(jdec.DecoderConfig(**fields), seed=0)
        ids, am = _prompt(4, 9, fields["vocab_size"], pads)
        cases.append((fields, jp, ids, am, not cases))
    ranks = _run(cases, 4, 2)
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for i, (fields, jp, ids, am, spec) in enumerate(cases):
        jax_tp, jax_single = _jax_tokens(fields, jp, ids, am, 4, 2)
        single = _single(fields, jp, ids, am)
        np.testing.assert_array_equal(jax_tp, jax_single)
        np.testing.assert_array_equal(single, jax_single)
        for r in ranks:
            got = r["cases"][i]
            assert got["local_rows"] == 2
            assert got["vocab_split"] == (not fields.get("tie_embeddings", False)
                                          and fields["vocab_size"] % 2 == 0)
            np.testing.assert_array_equal(got["tokens"], jax_tp)
            if spec:
                want, steps = tdec.generate_tokens_spec(
                    tdec.decoder_params_from_numpy(_np(jp), device="cpu"), ids[:1], am[:1],
                    cfg=tdec.DecoderConfig(**fields), max_new_tokens=NEW, draft_k=4)
                np.testing.assert_array_equal(got["spec_tokens"], want.numpy())
                assert got["spec_steps"] == steps


def test_dp1_tp4_generation_matches_jax_gspmd():
    """dp 1 x tp 4 with 8 query / 4 kv heads (one kv head and 2 query heads
    a rank), left-padded prompts: every rank's tokens equal JAX's over a
    2 x 4 mesh and the single-rank port's."""
    fields = dict(TINY, hidden_size=64, num_heads=8, num_kv_heads=4, intermediate_size=128)
    jp = jdec.random_decoder_params(jdec.DecoderConfig(**fields), seed=1)
    ids, am = _prompt(2, 11, fields["vocab_size"], (0, 6), seed=1)
    ranks = _run([(fields, jp, ids, am, False)], 4, 4)
    jax_tp, jax_single = _jax_tokens(fields, jp, ids, am, 2, 4)
    np.testing.assert_array_equal(jax_tp, jax_single)
    np.testing.assert_array_equal(_single(fields, jp, ids, am), jax_tp)
    for r in ranks:
        assert r["cases"][0]["vocab_split"] and r["cases"][0]["local_rows"] == 2
        np.testing.assert_array_equal(r["cases"][0]["tokens"], jax_tp)


def _mesh(tp, m=0, dp=1, d=0):
    """A stand-in for a parallel.Mesh at model index m (no process group):
    what shard_decoder_params and shard_decoder_inputs read."""
    coords = {"data": d, "model": m}
    return SimpleNamespace(shape={"data": dp, "model": tp}, axis_names=("data", "model"),
                           index=coords.__getitem__)


@pytest.mark.parametrize("tp,m", [(2, 0), (2, 1), (4, 3)])
def test_shards_are_the_megatron_blocks(tp, m):
    """Rank m's leaves are the m-th block of q/k/v/gate/up columns (and the
    q/k/v biases), of o/down rows and of the head's vocab rows; embed and the
    norms are the same tensors."""
    fields = dict(TINY, hidden_size=64, num_heads=8, num_kv_heads=4, intermediate_size=128)
    cfg = tdec.DecoderConfig(**fields)
    full = tdec.random_decoder_params(cfg, seed=0, device="cpu")
    mine = tdec.shard_decoder_params(full, _mesh(tp, m), cfg)

    def block(t, dim):
        return torch.chunk(t, tp, dim=dim)[m]

    assert mine["embed"] is full["embed"] and mine["final_ln"] is full["final_ln"]
    torch.testing.assert_close(mine["lm_head"], block(full["lm_head"], 0), rtol=0, atol=0)
    for lp, lf in zip(mine["layers"], full["layers"]):
        for name in ("q_w", "k_w", "v_w", "gate_w", "up_w", "q_b", "k_b", "v_b"):
            torch.testing.assert_close(lp[name], block(lf[name], -1), rtol=0, atol=0)
        for name in ("o_w", "down_w"):
            torch.testing.assert_close(lp[name], block(lf[name], 0), rtol=0, atol=0)
        assert lp["ln1"] is lf["ln1"] and lp["ln2"] is lf["ln2"]
    assert mine["tp"].tp == tp and mine["tp"].vocab_split


def test_inputs_are_this_ranks_rows():
    ids, am = _prompt(6, 5, 50, (1, 2))
    for d in range(3):
        lids, lam = tdec.shard_decoder_inputs(ids, am, _mesh(2, dp=3, d=d))
        np.testing.assert_array_equal(lids.numpy(), ids[2 * d:2 * d + 2])
        np.testing.assert_array_equal(lam.numpy(), am[2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="not divisible"):
        tdec.shard_decoder_inputs(ids, am, _mesh(1, dp=4))


def test_kv_heads_that_do_not_divide_the_axis_are_refused():
    """As the JAX package (tests/test_parallel.py): an AssertionError."""
    bad = tdec.DecoderConfig(**dict(TINY, num_layers=1, num_kv_heads=1))
    with pytest.raises(AssertionError):
        tdec.shard_decoder_params(tdec.random_decoder_params(bad, 0, device="cpu"), _mesh(2), bad)


@pytest.mark.parametrize("layout", ["fused", "int8", "int8_fused"])
def test_fused_and_int8_layouts_are_refused(layout):
    cfg = tdec.DecoderConfig(**TINY)
    params = tdec.random_decoder_params(cfg, 0, device="cpu")
    if "int8" in layout:
        params = tdec.quantize_decoder_params(params)
    if "fused" in layout:
        params = tdec.fuse_decoder_params(params)
    with pytest.raises(ValueError, match="split float layout"):
        tdec.shard_decoder_params(params, _mesh(2), cfg)
