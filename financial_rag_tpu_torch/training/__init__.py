"""Fine-tuning of the encoders and the cross-encoder on one device or a
(data, model) mesh of ranks."""

from financial_rag_tpu_torch.training.contrastive import (
    adamw,
    contrastive_loss,
    gather_params,
    make_train_step,
    param_sharding_rules,
    shard_params,
)
from financial_rag_tpu_torch.training.data import PairBatcher, pseudo_pairs_from_children
from financial_rag_tpu_torch.training.rerank_ft import (
    ListwiseBatcher,
    make_rerank_train_step,
    mine_feedback_triples,
)

__all__ = [
    "adamw",
    "contrastive_loss",
    "gather_params",
    "make_train_step",
    "param_sharding_rules",
    "shard_params",
    "PairBatcher",
    "pseudo_pairs_from_children",
    "ListwiseBatcher",
    "make_rerank_train_step",
    "mine_feedback_triples",
]
