"""Contrastive fine-tuning of the retrieval encoders on one GPU or a mesh.

Counterpart of financial_rag_tpu/training/contrastive.py: in-batch-negative
InfoNCE (the standard dual-encoder recipe behind bge/gte) as one train step
with the JAX package's call shape, ``params, opt_state, loss = step(params,
opt_state, batch)``.

The step keeps float32 master weights and runs the encoder in the compute
dtype (bf16 on the GPU) through the fused path the JAX package trains
through on its accelerator (``attention_impl="pallas"``): attention is K2
forward and K10 backward, the FFN is K3 forward with a rematerialising
backward. Mean pooling takes the differentiable plain formula (K1 has no
backward), as the JAX package's training pools through XLA. The optimizer
updates the parameter tensors in place, so ``step`` returns the tree it was
given.

On a (data, model) mesh (parallel/mesh.py; one process per rank) the step
is the JAX package's GSPMD step written out: each rank takes its block of
the batch's rows (data rank order), its shards of the parameters
(:func:`param_sharding_rules`, :func:`shard_params`) and, with a model axis
larger than 1, runs the ``pallas_tp`` layer (models/bert.py, K11). The loss
uses GLOBAL negatives, as in JAX: each data rank gathers every rank's
embeddings in rank order (parallel/comm.gather_from_data) and computes the
same global loss. Only its own rows carry a gradient there, so the data
axis SUMS the ranks' parameter gradients (a mean would give 1/dp of the
gradient with the same direction). AdamW is elementwise, so it runs on the
shards and equals the unsharded update.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.bert import bert_encode
from financial_rag_tpu_torch.models.encoder import default_compute_dtype
from financial_rag_tpu_torch.ops import flash_attention, fused_ffn
from financial_rag_tpu_torch.ops.common import built_head_dim
from financial_rag_tpu_torch.parallel import comm

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def adamw(lr: float, *, weight_decay: float = 1e-4, betas=(0.9, 0.999),
          eps: float = 1e-8) -> OptimizerFactory:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults. The two apply
    the same decoupled decay, but torch's default weight decay is 1e-2 and
    optax's 1e-4, so it is passed explicitly."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay)


def contrastive_loss(q_emb: torch.Tensor, d_emb: torch.Tensor,
                     temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives. Embeddings are unit-norm;
    the logits are f32."""
    logits = (q_emb.float() @ d_emb.float().T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


# The dim of each stacked layer leaf ([num_layers, ...]) that the model axis
# splits: q/k/v/ffn_in on their output dim, o/ffn_out on their input dim
# (the JAX rules, contrastive.py:32-58). Every other leaf is replicated.
LAYER_SPLIT_DIMS = {"q_w": 2, "q_b": 1, "k_w": 2, "k_b": 1, "v_w": 2, "v_b": 1,
                    "o_w": 1, "ffn_in_w": 2, "ffn_in_b": 1, "ffn_out_w": 1}
REPLICATED_LAYER_LEAVES = ("o_b", "attn_ln_scale", "attn_ln_bias", "ffn_out_b",
                           "ffn_ln_scale", "ffn_ln_bias")


def param_sharding_rules(mesh=None) -> Dict[str, Any]:
    """For each leaf of the encoder tree, the dim the model axis splits, or
    None (replicated); leaves outside the tree (pooler, classifier) are
    replicated too. The tree of financial_rag_tpu's PartitionSpecs, with
    each spec's ``model`` position as an int; ``mesh`` is taken for the
    JAX call shape, the rules do not depend on it."""
    return {
        "embeddings": {name: None for name in ("word", "position", "token_type",
                                               "ln_scale", "ln_bias")},
        "layers": {**{name: None for name in REPLICATED_LAYER_LEAVES}, **LAYER_SPLIT_DIMS},
    }


def _split_dim(rules, group: str, name: str):
    return rules.get(group, {}).get(name)


def shard_params(params, mesh, model_axis: str = "model"):
    """This rank's slices of ``params``: each split leaf cut into
    ``mesh.shape[model_axis]`` equal blocks along its dim, block
    ``mesh.index(model_axis)`` kept (contiguous copies); replicated leaves
    as they are. The identity without a model axis."""
    tp, rules = comm.axis_size(mesh, model_axis), param_sharding_rules(mesh)
    out = {}
    for group, leaves in params.items():
        out[group] = {}
        for name, t in leaves.items():
            t = torch.as_tensor(t)
            dim = _split_dim(rules, group, name)
            if dim is not None and tp > 1:
                if t.shape[dim] % tp:
                    raise ValueError(f"{group}/{name}: dim {dim} of {tuple(t.shape)} does not "
                                     f"split over tp={tp}")
                w = t.shape[dim] // tp
                t = t.narrow(dim, mesh.index(model_axis) * w, w).contiguous()
            out[group][name] = t
    return out


def gather_params(params, mesh, model_axis: str = "model"):
    """The full tree from every model rank's shards (detached; in rank
    order along each split dim). Every rank of the mesh must call it."""
    tp, rules = comm.axis_size(mesh, model_axis), param_sharding_rules(mesh)
    out = {}
    for group, leaves in params.items():
        out[group] = {}
        for name, t in leaves.items():
            dim = _split_dim(rules, group, name)
            out[group][name] = (comm.all_gather(t, mesh, model_axis, dim)
                                if dim is not None and tp > 1 else t.detach())
    return out


def local_rows(batch: Dict[str, Any], mesh, data_axis: str = "data") -> Dict[str, Any]:
    """This data rank's block of every batch leaf's rows, in rank order."""
    dp = comm.axis_size(mesh, data_axis)
    if dp == 1:
        return batch
    i, out = mesh.index(data_axis), {}
    for key, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"batch {key}: {v.shape[0]} rows do not split over dp={dp}")
        b = v.shape[0] // dp
        out[key] = v[i * b:(i + 1) * b]
    return out


def sync_grads(grads: List[torch.Tensor], mesh, axis: str, op: str) -> List[torch.Tensor]:
    """All-reduce every gradient over ``axis`` in one f32 buffer."""
    if comm.axis_size(mesh, axis) == 1:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    comm.all_reduce_(flat, mesh, axis, op)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
        at += g.numel()
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in its iteration order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """A nested dict shaped like ``tree`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    return build(tree)


def master_params(params, device: torch.device):
    """Float32 copies of every leaf on ``device``, each a leaf of autograd."""
    return tree_unflatten(params, [
        leaf.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True)
        for leaf in tree_leaves(params)])


def resolve_compute_dtype(device: torch.device, compute_dtype) -> torch.dtype:
    """bf16 on the GPU, f32 on the CPU by default. The CUDA kernels of the
    step (K2, K10, K3) take bf16, so f32 compute on the GPU raises."""
    dt = compute_dtype or default_compute_dtype(device)
    if device.type == "cuda" and dt != torch.bfloat16:
        raise ValueError(f"the train step's CUDA kernels take bfloat16; compute_dtype={dt} "
                         f"runs on the CPU only")
    return dt


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            .to(device) for k, v in batch.items()}


def make_step(loss_fn, device: torch.device, optimizer: OptimizerFactory,
              compute_dtype: torch.dtype, *, mesh=None, data_axis: str = "data",
              model_axis: str = "model", grad_reduce: str = "sum",
              loss_reduce: Optional[str] = None):
    """(step, init_state) around ``loss_fn(params, local_batch) -> scalar``.
    ``step.value_and_grad(params, batch)`` gives the loss and the gradient
    tree the step applies. On a mesh, ``batch`` is the global batch: each
    rank takes its rows (:func:`local_rows`), its gradients are all-reduced
    over the data axis by ``grad_reduce`` ("sum" or "mean"), and
    ``loss_reduce="mean"`` averages the ranks' losses. The model ranks
    compute the replicated leaves' gradients from the same values with
    run-independent kernels (models/bert.py), so the replicas stay
    identical with no model-axis collective."""
    tp = comm.axis_size(mesh, model_axis)

    def value_and_grad(params, batch):
        loss = loss_fn(params, batch_to_device(local_rows(batch, mesh, data_axis), device))
        # leaves the loss does not reach (a pooler the contrastive loss never
        # uses) get zeros, as jax.value_and_grad gives them: AdamW then still
        # decays them, as optax.adamw does
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                    materialize_grads=True)
        grads = sync_grads(list(grads), mesh, data_axis, grad_reduce)
        loss = loss.detach().float()
        if loss_reduce is not None:
            loss = comm.all_reduce_(loss.clone(), mesh, data_axis, loss_reduce)
        return loss, tree_unflatten(params, grads)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    def init_state(params):
        params = master_params(shard_params(params, mesh, model_axis), device)
        return params, optimizer(tree_leaves(params))

    step.value_and_grad = value_and_grad
    # the JAX package's names: the fused path (K2/K10 attention, K3 FFN), or
    # its tensor-parallel layer (K11 attention, the XLA-style FFN)
    step.attention_impl = "pallas_tp" if tp > 1 else "pallas"
    step.mesh = mesh
    step.device = device
    step.compute_dtype = compute_dtype
    return step, init_state


def tp_arg(config: ModelConfig, mesh, model_axis: str):
    """bert's ``tp`` argument for a mesh: (mesh, model axis), or None
    without a model axis; raises where the heads do not split over it."""
    tp = comm.axis_size(mesh, model_axis)
    if tp == 1:
        return None
    if config.num_heads % tp:
        raise ValueError(f"num_heads={config.num_heads} not divisible by tp={tp}")
    return (mesh, model_axis)


def check_train_widths(config: ModelConfig, device: torch.device, tp=None) -> None:
    """On CUDA a training step runs the attention forward through K2 and
    its backward through K10, which take head_dim up to 64 (zero-padded to
    32 or 64: bge-small, bge-base, bge-large, TinyBERT and their kin), and,
    without a model axis (``tp`` None), every feed-forward forward through
    K3, which takes hidden and intermediate multiples of 8 (a
    tensor-parallel layer's sharded feed-forward runs no K3): refuse
    another width when the step is made, not in the middle of its first
    forward or backward. The CPU trains at any width."""
    if device.type != "cuda":
        return
    if (config.hidden_size % config.num_heads
            or built_head_dim(config.hidden_size // config.num_heads,
                              flash_attention.BWD_HEAD_DIMS) is None):
        raise NotImplementedError(
            f"training on CUDA: head_dim {config.hidden_size / config.num_heads:g}, but the "
            f"attention backward (K10) takes head_dim <= {flash_attention.BWD_HEAD_DIMS[-1]} only")
    if tp is None and not fused_ffn.kernel_takes(config.hidden_size, config.intermediate_size):
        raise NotImplementedError(
            f"training on CUDA: hidden {config.hidden_size} / intermediate "
            f"{config.intermediate_size}, but the feed-forward (K3) takes hidden and "
            f"intermediate multiples of {fused_ffn.GENERIC_GRANULE} only")


def make_train_step(
    config: ModelConfig,
    mesh=None,
    *,
    device=None,
    optimizer: Optional[OptimizerFactory] = None,
    pooling: str = "mean",
    temperature: float = 0.05,
    compute_dtype: Optional[torch.dtype] = None,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Returns (train_step, init_state). Batch dict keys: q_ids, q_mask,
    d_ids, d_mask (all [B, S] int, numpy or torch; B divisible by the data
    axis's size). ``mesh``: a parallel.Mesh, every rank of which calls the
    step with the same global batch; None is one device. ``optimizer``
    builds a torch optimizer from the list of parameter tensors; the
    default, ``adamw(1e-5)``, is ``optax.adamw(1e-5)``. ``init_state(params)``
    takes a full parameter tree (any device and dtype) and returns f32
    master copies of this rank's shards on the device with the optimizer
    over them."""
    device = resolve_device(device)
    tp = tp_arg(config, mesh, model_axis)
    check_train_widths(config, device, tp)
    dt = resolve_compute_dtype(device, compute_dtype)

    def loss_fn(params, batch):
        q_emb = bert_encode(params, batch["q_ids"], batch["q_mask"], config=config,
                            pooling=pooling, compute_dtype=dt, fused_pool=False, tp=tp)
        d_emb = bert_encode(params, batch["d_ids"], batch["d_mask"], config=config,
                            pooling=pooling, compute_dtype=dt, fused_pool=False, tp=tp)
        return contrastive_loss(comm.gather_from_data(q_emb, mesh, data_axis),
                                comm.gather_from_data(d_emb, mesh, data_axis), temperature)

    return make_step(loss_fn, device, optimizer or adamw(1e-5), dt, mesh=mesh,
                     data_axis=data_axis, model_axis=model_axis, grad_reduce="sum")
