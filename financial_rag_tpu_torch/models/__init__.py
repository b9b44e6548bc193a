from financial_rag_tpu_torch.models.bert import (
    BertParams,
    bert_encode,
    bert_forward,
    cross_encoder_forward,
)
from financial_rag_tpu_torch.models.checkpoint import (
    load_params,
    params_from_numpy,
    params_from_torch_state_dict,
    random_params,
)

__all__ = [
    "BertParams",
    "bert_forward",
    "bert_encode",
    "cross_encoder_forward",
    "load_params",
    "params_from_numpy",
    "random_params",
    "params_from_torch_state_dict",
]
