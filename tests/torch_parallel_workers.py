"""Rank functions for tests/test_torch_parallel.py (CPU, gloo) and
tests/test_torch_cuda.py (ranks sharing the card over gloo).

``parallel.launch.spawn`` starts each rank in a fresh process that imports
the rank function's module by name. This module imports no JAX (and the
test file's JAX imports stay in the pytest process), so a rank starts in
about a second. Every function takes ``(rank, world, device, ...)`` and
returns numpy arrays or plain data.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.models import bert, decoder
from financial_rag_tpu_torch.ops import flash_attention as fa
from financial_rag_tpu_torch.parallel import comm, make_mesh, train_mesh
from financial_rag_tpu_torch.training import contrastive, rerank_ft

# The timeout of every group, the default group's (spawn's timeout_s) too
GROUP_TIMEOUT_S = 60.0


def _np_tree(tree):
    return {g: {k: t.detach().float().cpu().numpy() for k, t in leaves.items()}
            for g, leaves in tree.items()}


def _optimizer(spec):
    name, lr = spec
    if name == "sgd":
        return functools.partial(torch.optim.SGD, lr=lr)
    return contrastive.adamw(lr)


def attention_tp(rank, world, device, q, k, v, do, bias, num_heads, tp):
    """K11 on this rank's rows and heads of full [B,S,H] inputs: the local
    output and dq/dk/dv, with the launch-free CPU path."""
    mesh = train_mesh(tp, timeout_s=GROUP_TIMEOUT_S)
    d, m = mesh.index("data"), mesh.index("model")
    b = q.shape[0] // mesh.shape["data"]
    w = q.shape[2] // tp
    rows, cols = slice(d * b, (d + 1) * b), slice(m * w, (m + 1) * w)
    lq, lk, lv = (torch.from_numpy(np.ascontiguousarray(a[rows, :, cols])).requires_grad_()
                  for a in (q, k, v))
    out = fa.flash_attention_tp(lq, lk, lv, torch.from_numpy(bias[rows]), num_heads=num_heads,
                                mesh=mesh, head_dim=q.shape[2] // num_heads)
    grads = torch.autograd.grad(out, (lq, lk, lv),
                                torch.from_numpy(np.ascontiguousarray(do[rows, :, cols])))
    return {"coords": (d, m), "out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def shards(rank, world, device, params, tp):
    """This rank's shard_params slices, and gather_params of them."""
    mesh = train_mesh(tp, timeout_s=GROUP_TIMEOUT_S)
    mine = contrastive.shard_params(params, mesh)
    return {"coords": (mesh.index("data"), mesh.index("model")),
            "shards": _np_tree(mine),
            "gathered": _np_tree(contrastive.gather_params(mine, mesh))}


def forward_tp(rank, world, device, cfg_fields, params, ids, mask, tp):
    """bert_forward of this rank's rows on its shards under the mesh."""
    cfg = ModelConfig(**cfg_fields)
    mesh = train_mesh(tp, timeout_s=GROUP_TIMEOUT_S)
    rows = contrastive.local_rows({"ids": ids, "mask": mask}, mesh)
    out = bert.bert_forward(contrastive.shard_params(params, mesh),
                            torch.from_numpy(rows["ids"]), torch.from_numpy(rows["mask"]),
                            config=cfg, tp=mesh)
    return {"coords": (mesh.index("data"), mesh.index("model")), "hidden": out.numpy()}


def train_steps(rank, world, device, trainer, cfg_fields, params, batches, tp, opt):
    """``len(batches)`` steps of a trainer on a dp x tp mesh: each step's
    loss, the gathered parameters, and a digest of every replicated leaf."""
    cfg = ModelConfig(**cfg_fields)
    mesh = train_mesh(tp, timeout_s=GROUP_TIMEOUT_S)
    make = (contrastive.make_train_step if trainer == "contrastive"
            else rerank_ft.make_rerank_train_step)
    step, init_state = make(cfg, mesh, device=device, optimizer=_optimizer(opt))
    p, o = init_state(params)
    losses = []
    for batch in batches:
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))
    rules = contrastive.param_sharding_rules(mesh)
    digest = {f"{g}/{n}": hashlib.sha256(t.detach().numpy().tobytes()).hexdigest()
              for g, leaves in p.items() for n, t in leaves.items()
              if rules.get(g, {}).get(n) is None}
    return {"coords": (mesh.index("data"), mesh.index("model")), "losses": losses,
            "attention_impl": step.attention_impl,
            "params": _np_tree(contrastive.gather_params(p, mesh)), "replicated": digest}


def contrastive_grads_and_controls(rank, world, device, cfg_fields, params, batch, tp):
    """One contrastive step's gathered gradients on a dp x tp mesh, right and
    under the three controls: K11 fed the model neighbour's k/v heads,
    copy_to_model without its backward all-reduce, and a data all-reduce
    that averages where it must sum."""
    cfg = ModelConfig(**cfg_fields)
    mesh = train_mesh(tp, timeout_s=GROUP_TIMEOUT_S)
    step, init_state = contrastive.make_train_step(cfg, mesh, device=device)
    p, _ = init_state(params)
    out = {}

    def run(name):
        loss, grads = step.value_and_grad(p, batch)
        out[name] = {"loss": float(loss),
                     "grads": _np_tree(contrastive.gather_params(grads, mesh))}

    run("right")
    k11, copy = bert.flash_attention_tp, comm.copy_to_model
    n, m = mesh.shape["model"], mesh.index("model")

    def neighbour_kv(q, k, v, bias, **kw):
        w = k.shape[-1]
        nb = (m + 1) % n
        k, v = (comm.all_gather(t, mesh, "model", dim=2)[..., nb * w:(nb + 1) * w]
                for t in (k, v))
        return k11(q, k.contiguous(), v.contiguous(), bias, **kw)

    try:
        bert.flash_attention_tp = neighbour_kv
        run("neighbour_kv")
        bert.flash_attention_tp = k11
        comm.copy_to_model = lambda x, mesh, axis="model": x
        run("copy_without_allreduce")
    finally:
        bert.flash_attention_tp, comm.copy_to_model = k11, copy
    sync = contrastive.sync_grads
    try:
        contrastive.sync_grads = lambda g, mesh, axis, op: sync(g, mesh, axis, "mean")
        run("data_mean")
    finally:
        contrastive.sync_grads = sync
    return out


def raise_on_rank(rank, world, device, bad):
    """Rank ``bad`` raises; the others wait in a collective it never joins."""
    if rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return rank


def mesh_layout(rank, world, device, axes):
    mesh = make_mesh(axes, timeout_s=GROUP_TIMEOUT_S)
    x = torch.tensor([float(rank)])
    sums = {name: float(comm.all_reduce_(x.clone(), mesh, name)) for name in mesh.axis_names}
    return {"shape": mesh.shape, "coords": mesh.coords, "sums": sums}


def step_grads(rank, world, device, cfg_fields, params, batch, tp):
    """One contrastive step's loss and gradients on a dp x tp mesh; rank 0
    returns them gathered over the model axis, with its K11 launches."""
    cfg = ModelConfig(**cfg_fields)
    mesh = train_mesh(tp, timeout_s=GROUP_TIMEOUT_S)
    step, init_state = contrastive.make_train_step(cfg, mesh, device=device)
    p, _ = init_state(params)
    before = (fa.TP_LAUNCHES, fa.TP_BWD_LAUNCHES)
    loss, grads = step.value_and_grad(p, batch)
    grads = contrastive.gather_params(grads, mesh)
    launches = (fa.TP_LAUNCHES - before[0], fa.TP_BWD_LAUNCHES - before[1])
    return {"loss": float(loss), "launches": launches,
            "grads": _np_tree(grads) if rank == 0 else None}


def decoder_tp_generate(rank, world, device, cases, tp, new):
    """Each case ``(cfg fields, numpy decoder tree, ids, mask, spec)``:
    generate_tokens on this rank's shard_decoder_params slice and
    shard_decoder_inputs rows (the whole [B, new] batch comes back), and
    with ``spec`` generate_tokens_spec of the first row (every rank feeds it
    whole). Returns the tokens, the spec tokens and steps, and whether the
    head's vocab rows were split."""
    mesh = train_mesh(tp, timeout_s=GROUP_TIMEOUT_S)
    out = []
    for fields, tree, ids, mask, spec in cases:
        cfg = decoder.DecoderConfig(**fields)
        params = decoder.shard_decoder_params(
            decoder.decoder_params_from_numpy(tree, device=device), mesh, cfg)
        lids, lmask = decoder.shard_decoder_inputs(ids, mask, mesh)
        toks = decoder.generate_tokens(params, lids, lmask, cfg=cfg, max_new_tokens=new)
        r = {"tokens": toks.cpu().numpy(), "vocab_split": params["tp"].vocab_split,
             "local_rows": int(lids.shape[0])}
        if spec:
            stoks, steps = decoder.generate_tokens_spec(params, ids[:1], mask[:1], cfg=cfg,
                                                        max_new_tokens=new, draft_k=4)
            r.update(spec_tokens=stoks.numpy(), spec_steps=steps)
        out.append(r)
    return {"coords": (mesh.index("data"), mesh.index("model")), "cases": out}
