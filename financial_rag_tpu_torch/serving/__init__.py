from financial_rag_tpu_torch.serving.app import create_app

__all__ = ["create_app"]
