"""Contrastive fine-tuning of the retrieval encoders on one GPU.

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
given. There is no mesh: data and tensor parallelism (and
``param_sharding_rules``) wait for the multi-GPU slice of the port.
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
              compute_dtype: torch.dtype):
    """(step, init_state) around ``loss_fn(params, batch) -> scalar``.
    ``step.value_and_grad(params, batch)`` gives the loss and the gradient
    tree the step applies."""

    def value_and_grad(params, batch):
        loss = loss_fn(params, batch_to_device(batch, device))
        # leaves the loss does not reach (a pooler the contrastive loss never
        # uses) get zeros, as jax.value_and_grad gives them: AdamW then still
        # decays them, as optax.adamw does
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), tree_unflatten(params, grads)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    def init_state(params):
        params = master_params(params, device)
        return params, optimizer(tree_leaves(params))

    step.value_and_grad = value_and_grad
    # the JAX package's name for the fused path (K2/K10 attention, K3 FFN)
    step.attention_impl = "pallas"
    step.device = device
    step.compute_dtype = compute_dtype
    return step, init_state


def make_train_step(
    config: ModelConfig,
    *,
    device=None,
    optimizer: Optional[OptimizerFactory] = None,
    pooling: str = "mean",
    temperature: float = 0.05,
    compute_dtype: Optional[torch.dtype] = None,
):
    """Returns (train_step, init_state). Batch dict keys: q_ids, q_mask,
    d_ids, d_mask (all [B, S] int, numpy or torch). ``optimizer`` builds a
    torch optimizer from the list of parameter tensors; the default,
    ``adamw(1e-5)``, is ``optax.adamw(1e-5)``. ``init_state(params)`` takes
    a parameter tree (any device and dtype) and returns its f32 master
    copy on the device with the optimizer over it."""
    device = resolve_device(device)
    dt = resolve_compute_dtype(device, compute_dtype)

    def loss_fn(params, batch):
        q_emb = bert_encode(params, batch["q_ids"], batch["q_mask"], config=config,
                            pooling=pooling, compute_dtype=dt, fused_pool=False)
        d_emb = bert_encode(params, batch["d_ids"], batch["d_mask"], config=config,
                            pooling=pooling, compute_dtype=dt, fused_pool=False)
        return contrastive_loss(q_emb, d_emb, temperature)

    return make_step(loss_fn, device, optimizer or adamw(1e-5), dt)
