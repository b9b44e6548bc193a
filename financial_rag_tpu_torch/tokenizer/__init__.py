from financial_rag_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer
from financial_rag_tpu_torch.tokenizer.vocab import load_vocab, default_vocab_path

__all__ = ["WordPieceTokenizer", "load_vocab", "default_vocab_path"]
