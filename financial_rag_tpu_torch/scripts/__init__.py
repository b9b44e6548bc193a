"""Command-line entry points of the port, run as ``python -m
financial_rag_tpu_torch.scripts.<name>``."""
