"""The port's data- and tensor-parallel training against the JAX package's.

The port runs one process per rank (``parallel.launch.spawn``, ``gloo`` on
the CPU, the rank functions in tests/torch_parallel_workers.py, which
imports no JAX); the JAX package runs its GSPMD step in this process on
tests/conftest.py's 8 virtual CPU devices, with ``pallas_tp`` (the Pallas
kernel shard_mapped over local heads) in interpret mode. Both take the
same numpy inputs and the same seeded weights (the two ``random_params``
draw the same numbers). Every tolerance is stated beside its check. Each
launch has its own time limit (240 s, ``spawn``'s ``join_timeout_s``) and
each process group a 60 s timeout.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding

import torch_parallel_workers as workers
from financial_rag_tpu.config import ModelConfig as JaxModelConfig
from financial_rag_tpu.models.bert import bert_forward as jax_bert_forward
from financial_rag_tpu.models.checkpoint import random_params as jax_random_params
from financial_rag_tpu.ops.flash_attention import flash_attention_tp as jax_flash_attention_tp
from financial_rag_tpu.training import contrastive as jax_contrastive
from financial_rag_tpu.training import rerank_ft as jax_rerank_ft
from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.models.checkpoint import random_params
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.parallel import launch, train_mesh
from financial_rag_tpu_torch.training import contrastive

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(name="tiny", hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
            vocab_size=256, max_position=32)
MESHES = {"dp2xtp2": (2, 2), "dp1xtp4": (1, 4), "dp4xtp1": (4, 1)}


def _spawn(fn, world, *args):
    return launch.spawn(fn, world, args=args, device="cpu", timeout_s=workers.GROUP_TIMEOUT_S,
                        join_timeout_s=240)


def _jax_mesh(dp, tp):
    devices = jax.devices()
    if len(devices) < dp * tp:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return Mesh(np.array(devices[:dp * tp]).reshape(dp, tp), ("data", "model"))


def _np_params(cfg, seed):
    return {g: {k: t.numpy() for k, t in leaves.items()}
            for g, leaves in random_params(cfg, seed=seed).items()}


def _pair_batch(seed, b=8, s=16, vocab=256):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "d"):
        lens = rng.integers(3, s + 1, size=b)
        lens[0] = s
        out[f"{side}_ids"] = rng.integers(5, vocab, size=(b, s)).astype(np.int32)
        out[f"{side}_mask"] = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return out


def _group_batch(seed, b=4, g=3, s=16, vocab=256):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, s + 1, size=(b, g))
    mask = (np.arange(s)[None, None, :] < lens[:, :, None]).astype(np.int32)
    types = ((np.arange(s)[None, None, :] >= (lens[:, :, None] // 2)) * mask).astype(np.int32)
    return {"ids": rng.integers(5, vocab, size=(b, g, s)).astype(np.int32),
            "mask": mask, "types": types}


def _rank_of(mesh, device):
    d, m = np.argwhere(mesh.devices == device)[0]
    return int(d) * mesh.shape["model"] + int(m)


# ------------------------------------------------------------------ mesh


def test_single_process_mesh_is_one_by_one_without_groups():
    """No process group: every mesh is 1 x 1, no axis has a group, and
    asking for more ranks than the group has raises."""
    mesh = train_mesh(1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert mesh.group("data") is None and mesh.group("model") is None
    with pytest.raises(ValueError, match="process group has 1"):
        train_mesh(2, world=4)


def test_mesh_places_ranks_as_jax_places_devices():
    """make_mesh([("data", -1), ("model", 2)]) over 4 ranks: rank = d*tp + m,
    as np.arange(world).reshape(sizes) lays out JAX devices; each axis's
    all-reduce sums exactly the ranks of its line."""
    out = _spawn(workers.mesh_layout, 4, [("data", -1), ("model", 2)])
    for rank, r in enumerate(out):
        d, m = divmod(rank, 2)
        assert r["shape"] == {"data": 2, "model": 2} and r["coords"] == {"data": d, "model": m}
        assert r["sums"] == {"data": float(m + (2 + m)), "model": float(2 * d + 2 * d + 1)}


def test_backend_choice_is_explicit(monkeypatch):
    """NCCL with a GPU per rank, gloo when ranks share GPUs, gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launch.choose_backend(4, "cuda") == ("gloo", 1)
    assert launch.rank_device(3, "cuda", 1) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.choose_backend(4, "cuda") == ("nccl", 4)
    assert launch.choose_backend(4, "cpu") == ("gloo", 0)


def test_spawn_raises_and_does_not_hang_when_a_rank_raises():
    """Rank 1 raises while ranks 0, 2 and 3 wait in an all-reduce it never
    joins: spawn stops them and raises with rank 1's traceback, in well
    under the 60 s collective timeout."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        _spawn(workers.raise_on_rank, 4, 1)
    assert time.monotonic() - t0 < 30


# --------------------------------------------------------------- K11


@pytest.mark.parametrize("head_dim", [32, 64])
def test_flash_attention_tp_matches_jax_on_dp2_tp2(head_dim):
    """K11 on each rank's rows and heads (4 heads of 32, or of 64 as at the
    bge-base width; 2 per rank) against the JAX flash_attention_tp on a
    dp2 x tp2 mesh (the Pallas kernel in interpret mode) and its VJP, f32,
    padded keys and a fully masked row: each rank's output and dq/dk/dv
    slices within 1e-5."""
    rng = np.random.default_rng(3)
    b, s, heads = 4, 24, 4
    h = heads * head_dim
    q, k, v, do = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[1, 17:] = 0
    mask[3] = 0
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    mesh = _jax_mesh(2, 2)
    jbias = jnp.asarray(bias)[:, None, None, :]
    with mesh:
        out, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention_tp(
            a, b_, c, jbias, num_heads=heads, mesh=mesh), *(jnp.asarray(x) for x in (q, k, v)))
        jgrads = vjp(jnp.asarray(do))
    out, jgrads = np.asarray(out), [np.asarray(g) for g in jgrads]
    for r in _spawn(workers.attention_tp, 4, q, k, v, do, bias, heads, 2):
        d, m = r["coords"]
        rows, cols = slice(2 * d, 2 * d + 2), slice(h // 2 * m, h // 2 * (m + 1))
        np.testing.assert_allclose(r["out"], out[rows, :, cols], atol=1e-5, rtol=0)
        for g, jg in zip(r["grads"], jgrads):
            np.testing.assert_allclose(g, jg[rows, :, cols], atol=1e-5, rtol=0)


def test_flash_attention_tp_checks_heads_and_local_width():
    """The JAX message where heads do not split; a full-width q (not this
    rank's heads) is refused; the CPU path counts no launch."""
    class Tp2:
        shape = {"model": 2}

    x = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="num_heads=3 not divisible by tp=2"):
        fa.flash_attention_tp(x, x, x, torch.zeros(1, 4), num_heads=3, mesh=Tp2())
    with pytest.raises(ValueError, match="width 64"):
        fa.flash_attention_tp(torch.zeros(1, 4, 128), torch.zeros(1, 4, 128),
                              torch.zeros(1, 4, 128), torch.zeros(1, 4), num_heads=4, mesh=Tp2())
    before = (fa.TP_LAUNCHES, fa.TP_BWD_LAUNCHES)
    out = fa.flash_attention_tp(x, x, x, torch.zeros(1, 4), num_heads=4, mesh=Tp2())
    assert out.shape == x.shape and (fa.TP_LAUNCHES, fa.TP_BWD_LAUNCHES) == before


# ------------------------------------------- the TP layer's own functions


@pytest.mark.parametrize("rows", [2, 300])
def test_replicated_embedding_gradient_matches_f_embedding(rows):
    """The TP path's embedding lookup (a masked sum per row for a table of
    a few rows, index_add_ for a larger one on the CPU) gives F.embedding's
    output bit for bit and its table gradient within f32 rounding, with
    ids that repeat hundreds of times, and the same gradient bits on four
    more runs."""
    from financial_rag_tpu_torch.models.bert import _ReplicatedEmbedding

    gen = torch.Generator().manual_seed(rows)
    ids = torch.randint(0, rows, (8, 96), generator=gen)
    ids[:4] = 0
    table = torch.randn(rows, 48, generator=gen, requires_grad=True)
    g = torch.randn(8, 96, 48, generator=gen)
    out = _ReplicatedEmbedding.apply(ids, table)
    want = torch.nn.functional.embedding(ids, table)
    assert torch.equal(out, want)
    (got,) = torch.autograd.grad(out, table, g)
    (ref,) = torch.autograd.grad(want, table, g)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-5)
    for _ in range(4):
        (again,) = torch.autograd.grad(_ReplicatedEmbedding.apply(ids, table), table, g)
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_parallel_partial_product_is_f32_with_autograd_gradients(dtype):
    """The row-parallel partial product: float32 out of operands in x's
    dtype, equal to the product of the operands upcast (f32: x @ w itself),
    and gradients equal to autograd's of that product, rounded to x's dtype
    (bf16: within 2 ulps of the gradient's largest value)."""
    from financial_rag_tpu_torch.models.bert import _PartialProduct

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 64, generator=gen).to(dtype).requires_grad_()
    w = torch.randn(64, 32, generator=gen).to(dtype).requires_grad_()
    g = torch.randn(2, 5, 32, generator=gen).to(dtype).float()
    out = _PartialProduct.apply(x, w)
    assert out.dtype == torch.float32
    xf, wf = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
    want = xf @ wf
    assert torch.equal(out, want)
    got = torch.autograd.grad(out, (x, w), g)
    ref = torch.autograd.grad(want, (xf, wf), g)
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        tol = 0.0 if dtype == torch.float32 else 2.0 ** -7 * float(b.abs().max())
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=max(tol, 1e-5), rtol=0)


# ------------------------------------------------------- sharding rules


def test_shard_params_match_the_jax_named_sharding_shards():
    """param_sharding_rules / shard_params against the JAX package's
    NamedSharding shards on a dp2 x tp2 mesh: every rank's slice of every
    leaf equals the shard JAX places on the device at the same mesh
    position, and gather_params rebuilds the full tree exactly."""
    cfg, jcfg = ModelConfig(**TINY), JaxModelConfig(**TINY)
    params = _np_params(cfg, seed=4)
    mesh = _jax_mesh(2, 2)
    jshards = jax_contrastive.shard_params(
        jax.tree_util.tree_map(jnp.asarray, jax_random_params(jcfg, seed=4)), mesh)
    rules = contrastive.param_sharding_rules()
    assert {g: set(v) for g, v in rules.items()} == {
        g: set(v) for g, v in jax_contrastive.param_sharding_rules(mesh).items()}
    for g, leaves in jax_contrastive.param_sharding_rules(mesh).items():
        for n, spec in leaves.items():
            want = spec.index("model") if "model" in spec else None
            assert rules[g][n] == want, (g, n)
    out = _spawn(workers.shards, 4, params, 2)
    for g, leaves in jshards.items():
        for n, arr in leaves.items():
            assert isinstance(arr.sharding, NamedSharding)
            for shard in arr.addressable_shards:
                got = out[_rank_of(mesh, shard.device)]["shards"][g][n]
                np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=f"{g}/{n}")
    for r in out:
        for g, leaves in params.items():
            for n, full in leaves.items():
                np.testing.assert_array_equal(r["gathered"][g][n], full)


# ----------------------------------------------------------- forward


@pytest.mark.parametrize("tp", [2, 4])
def test_bert_forward_under_tp_matches_jax_pallas_tp(tp):
    """bert_forward on each rank's shards under a dp1 x tp mesh against the
    JAX bert_forward with attention_impl="pallas_tp" on the same mesh
    (K11 in interpret mode, the XLA erf FFN), f32, padded rows: every
    rank's hidden states within 2e-5 (the row-parallel sums run in
    another order)."""
    cfg, jcfg = ModelConfig(**TINY), JaxModelConfig(**TINY)
    params = _np_params(cfg, seed=5)
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 256, size=(4, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([16, 9, 3, 12])[:, None]).astype(np.int32)
    mesh = _jax_mesh(1, tp)
    jparams = jax_contrastive.shard_params(
        jax.tree_util.tree_map(jnp.asarray, jax_random_params(jcfg, seed=5)), mesh)
    with mesh:
        want = np.asarray(jax.jit(lambda p, i, m: jax_bert_forward(
            p, i, m, config=jcfg, attention_impl="pallas_tp", tp_mesh=mesh))(
                jparams, jnp.asarray(ids), jnp.asarray(mask)))
    for r in _spawn(workers.forward_tp, tp, TINY, params, ids, mask, tp):
        np.testing.assert_allclose(r["hidden"], want, atol=2e-5, rtol=0)


# -------------------------------------------------------- train steps


def _assert_params_close(got, want, what, skip=()):
    for g, leaves in want.items():
        for n, w in leaves.items():
            if n in skip:
                continue
            np.testing.assert_allclose(got[g][n], np.asarray(w), atol=2e-5, rtol=2e-4,
                                       err_msg=f"{what}: {g}/{n}")


def _jax_step(make, jcfg, mesh, params_seed, opt, impl, batches):
    tx = optax.sgd(opt[1]) if opt[0] == "sgd" else optax.adamw(opt[1])
    step, init_state = make(jcfg, mesh, optimizer=tx, attention_impl=impl)
    assert step.attention_impl == impl
    p, o = init_state(jax_random_params(jcfg, seed=params_seed))
    losses = []
    with mesh:
        for batch in batches:
            p, o, loss = step(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("opt", [("sgd", 0.1), ("adamw", 1e-4)], ids=["sgd", "adamw"])
@pytest.mark.parametrize("layout,heads", [*((layout, 4) for layout in MESHES), ("dp2xtp2", 2)],
                         ids=[*MESHES, "dp2xtp2-head_dim64"])
def test_contrastive_step_matches_jax_pallas_tp(layout, heads, opt):
    """One contrastive step on dp2 x tp2, dp1 x tp4 and dp4 x tp1 (4 heads
    of 32), and on dp2 x tp2 at 2 heads of 64 (the bge-base head width, one
    local head of 64 a rank), against the JAX make_train_step(mesh,
    attention_impl="pallas_tp") on the same mesh,
    with optax.sgd(0.1) and optax.adamw(1e-4) against their torch
    counterparts: loss within 1e-5, every parameter within atol 2e-5 and
    rtol 2e-4 (the bars of tests/test_parallel.py's pallas_tp test).
    Adam's first step moves an element by lr * g / (|g| + 1e-8), about
    lr * sign(g): at lr 1e-4 a wrong sign (2e-4) or a lost gradient (1e-4)
    is 5x past atol, while elements whose gradient is within a few 1e-9 of
    0 may move by a part of lr that differs between the packages (at 1e-3,
    2 of 65,536 ffn_out_w elements did, by 3.6e-5). k_b is left out: its
    whole gradient is zero up to rounding (softmax ignores a shift of
    every score), so Adam scales that noise to up to lr in either
    package. SGD's step is linear in the gradient and checks its scale."""
    dp, tp = MESHES[layout]
    fields = {**TINY, "num_heads": heads}
    cfg, jcfg = ModelConfig(**fields), JaxModelConfig(**fields)
    batch = _pair_batch(seed=6)
    losses, want = _jax_step(jax_contrastive.make_train_step, jcfg, _jax_mesh(dp, tp), 7, opt,
                             "pallas_tp", [batch])
    out = _spawn(workers.train_steps, dp * tp, "contrastive", fields, _np_params(cfg, 7),
                 [batch], tp, opt)
    for r in out:
        assert r["attention_impl"] == ("pallas_tp" if tp > 1 else "pallas")
        assert abs(r["losses"][0] - losses[0]) <= 1e-5, (r["losses"], losses)
        _assert_params_close(r["params"], want, layout,
                             skip=("k_b",) if opt[0] == "adamw" else ())


@pytest.mark.parametrize("heads", [4, 2])
def test_listwise_step_matches_jax_xla_on_dp2_tp2(heads):
    """One listwise rerank step (SGD 0.1) on dp2 x tp2, at heads of 32 and
    of 64, against the JAX make_rerank_train_step with attention_impl="xla"
    on the same mesh (its pallas_tp path crashes, below): loss within 1e-5,
    parameters within atol 2e-5 and rtol 2e-4. The data axis averages here:
    the listwise loss is a mean over each rank's own groups."""
    fields = {**TINY, "num_labels": 1, "num_heads": heads}
    cfg, jcfg = ModelConfig(**fields), JaxModelConfig(**fields)
    batch = _group_batch(seed=8)
    losses, want = _jax_step(jax_rerank_ft.make_rerank_train_step, jcfg, _jax_mesh(2, 2), 9,
                             ("sgd", 0.1), "xla", [batch])
    for r in _spawn(workers.train_steps, 4, "rerank", fields, _np_params(cfg, 9), [batch], 2,
                    ("sgd", 0.1)):
        assert r["attention_impl"] == "pallas_tp"
        assert abs(r["losses"][0] - losses[0]) <= 1e-5, (r["losses"], losses)
        _assert_params_close(r["params"], want, "listwise")


def test_jax_rerank_step_crashes_under_pallas_tp():
    """Pins the reference's fault that the port does not copy:
    make_rerank_train_step resolves "pallas_tp" on a TP mesh, but
    cross_encoder_forward passes no mesh to bert_forward, so
    flash_attention_tp gets mesh=None. The port passes its mesh through
    (the listwise test above)."""
    fields = {**TINY, "num_labels": 1}
    jcfg = JaxModelConfig(**fields)
    mesh = _jax_mesh(2, 2)
    step, init_state = jax_rerank_ft.make_rerank_train_step(
        jcfg, mesh, optimizer=optax.sgd(0.1), attention_impl="pallas_tp")
    p, o = init_state(jax_random_params(jcfg, seed=9))
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'shape'"):
        with mesh:
            step(p, o, {k: jnp.asarray(v) for k, v in _group_batch(seed=8).items()})


def test_replicated_leaves_stay_identical_across_tp_ranks_over_three_steps():
    """Three AdamW contrastive steps on dp2 x tp2: every replicated leaf
    (embeddings, layer norms, o_b, ffn_out_b, the pooler) is bit-identical
    on the two TP ranks of each data row, and on all four ranks; the
    losses are equal on every rank (global negatives) and fall."""
    cfg = ModelConfig(**TINY)
    batches = [_pair_batch(seed=s) for s in (10, 11, 10)]
    out = _spawn(workers.train_steps, 4, "contrastive", TINY, _np_params(cfg, 12), batches, 2,
                 ("adamw", 1e-3))
    assert len(out[0]["replicated"]) == 5 + 6 + 2
    for r in out[1:]:
        assert r["replicated"] == out[0]["replicated"]
        assert r["losses"] == out[0]["losses"]
    assert out[0]["losses"][2] < out[0]["losses"][0]


def test_gradient_gates_see_the_three_controls():
    """One contrastive step's gathered gradients on dp2 x tp2 against
    jax.value_and_grad of the JAX single-device loss (XLA path, f32): the
    right step agrees within 1e-5 of each leaf's largest value plus 1e-6
    of the largest gradient. Each control breaks a gate: K11 fed the model
    neighbour's k/v heads changes the loss; copy_to_model without its
    backward all-reduce leaves the q/k/v and lower gradients partial;
    averaging over the data axis halves every gradient (the cosine stays
    1, the norm ratio is 1/2)."""
    cfg, jcfg = ModelConfig(**TINY), JaxModelConfig(**TINY)
    batch = _pair_batch(seed=13)

    def loss_fn(p, bt):
        from financial_rag_tpu.models.bert import bert_encode
        q = bert_encode(p, bt["q_ids"], bt["q_mask"], config=jcfg, pooling="mean")
        d = bert_encode(p, bt["d_ids"], bt["d_mask"], config=jcfg, pooling="mean")
        return jax_contrastive.contrastive_loss(q, d, 0.05)

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, jax_random_params(jcfg, seed=14)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    floor = 1e-6 * max(np.abs(g).max() for leaves in jgrads.values() for g in leaves.values())

    def worst(got):
        return max(np.abs(got[g][n] - w).max() - 1e-5 * np.abs(w).max() - floor
                   for g, leaves in jgrads.items() for n, w in leaves.items())

    def ratio(got, names):
        a = np.concatenate([got["layers"][n].ravel() for n in names])
        b = np.concatenate([jgrads["layers"][n].ravel() for n in names])
        return np.linalg.norm(a) / np.linalg.norm(b)

    out = _spawn(workers.contrastive_grads_and_controls, 4, TINY, _np_params(cfg, 14), batch, 2)
    for r in out:
        assert abs(r["right"]["loss"] - float(jloss)) <= 1e-5
        assert worst(r["right"]["grads"]) <= 0
        assert abs(r["neighbour_kv"]["loss"] - float(jloss)) > 1e-3
        assert worst(r["copy_without_allreduce"]["grads"]) > 0
        assert abs(ratio(r["data_mean"]["grads"], ("q_w", "ffn_in_w")) - 0.5) < 1e-4


# ------------------------------------------------------------ dryrun


def test_dryrun_multichip_on_four_cpu_ranks(tmp_path):
    """scripts/dryrun_multichip.py --device cpu --world 4: one dp2 x tp2
    train step at the JAX dryrun's tiny config through pallas_tp, a finite
    loss; sections 2-4 and 6 over 4 devices (the sharded engine answering
    as the single-device one); section 5's dp2 x tp2 greedy tokens, which
    the script holds to the single-rank port, equal to the JAX dryrun's
    single-device generate_tokens on the same weights and prompts; one JSON
    line, exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "financial_rag_tpu_torch.scripts.dryrun_multichip",
         "--device", "cpu", "--world", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=170)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["ok"] and rep["mesh"] == {"data": 2, "model": 2}
    assert rep["attention_impl"] == "pallas_tp" and np.isfinite(rep["loss"])
    assert rep["sharded_search_shards"] == rep["sharded_ivf_shards"] == 4
    assert rep["dp_encode_max_abs_diff"] < 2e-5
    assert rep["engine"]["questions"] == 3 and rep["engine"]["joins"] >= 1
    assert "not_ported" not in rep
    dec = rep["decoder_tp"]
    assert dec["mesh"] == {"data": 2, "model": 2} and dec["hidden_size"] == 64

    from financial_rag_tpu.models import decoder as jdec
    from financial_rag_tpu_torch.scripts import dryrun_multichip as dry

    cfg = jdec.DecoderConfig(**dry.DECODER_TP)
    ids, mask = dry.decoder_prompt(2)
    want = jdec.generate_tokens(jdec.random_decoder_params(cfg, seed=0), jnp.asarray(ids),
                                jnp.asarray(mask), jax.random.PRNGKey(0), cfg=cfg,
                                max_new_tokens=dry.DECODER_NEW_TOKENS)
    np.testing.assert_array_equal(np.asarray(dec["tokens"]), np.asarray(want))
