"""One data- and tensor-parallel train step over several ranks.

    python -m financial_rag_tpu_torch.scripts.dryrun_multichip [--world 4] [--device cpu|cuda]

Counterpart of section 1 of the JAX package's ``dryrun_multichip``
(__graft_entry__.py:67-97): the contrastive train step on
``make_mesh([("data", -1), ("model", 2)])`` (tp 1 where the world size is
odd) at the dryrun's tiny config (2 layers, hidden 128, 4 heads of 32, FFN
256, vocab 512), batch 4 x dp pairs of 32 tokens, one step. With tp 2 the
step must resolve ``pallas_tp`` (K11 on the local heads) and every rank's
loss must be finite and equal. Each rank is a process (parallel/launch.py):
on the GPU they share the cards over gloo where there are fewer cards than
ranks, and take one each over NCCL otherwise. Prints one JSON line. The
dryrun's other sections (sharded search, data-parallel encode, sharded
IVF, tensor-parallel decoder, the sharded engine) wait for later work
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.checkpoint import random_params
from financial_rag_tpu_torch.parallel import launch, make_mesh
from financial_rag_tpu_torch.training.contrastive import make_train_step

# The timeout of every collective (the default group's and the mesh's)
TIMEOUT_S = 120
DRYRUN_CONFIG = dict(name="tiny-dryrun", hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512, max_position=64)


def train_rank(rank: int, world: int, device: torch.device) -> dict:
    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh([("data", -1), ("model", tp)], timeout_s=TIMEOUT_S)
    dp = mesh.shape["data"]
    config = ModelConfig(**DRYRUN_CONFIG)
    step, init_state = make_train_step(config, mesh, device=device)
    if tp > 1:
        assert step.attention_impl == "pallas_tp", step.attention_impl
    params, opt_state = init_state(random_params(config, seed=0))
    rng = np.random.default_rng(0)
    b, s = 4 * dp, 32
    batch = {"q_ids": rng.integers(1, 512, (b, s)).astype(np.int32),
             "q_mask": np.ones((b, s), np.int32),
             "d_ids": rng.integers(1, 512, (b, s)).astype(np.int32),
             "d_mask": np.ones((b, s), np.int32)}
    params, opt_state, loss = step(params, opt_state, batch)
    loss = float(loss)
    assert math.isfinite(loss), f"training step produced non-finite loss {loss}"
    return {"loss": loss, "mesh": dict(mesh.shape), "attention_impl": step.attention_impl,
            "device": str(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    backend, _ = launch.choose_backend(args.world, device.type)
    out = launch.spawn(train_rank, args.world, device=device, timeout_s=TIMEOUT_S)
    losses = [r["loss"] for r in out]
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    print(json.dumps({"ok": True, "world": args.world, "backend": backend, **out[0],
                      "rank_devices": [r["device"] for r in out]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
