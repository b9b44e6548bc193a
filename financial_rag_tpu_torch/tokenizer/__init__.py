from financial_rag_tpu_torch.tokenizer.hf_json import HFTokenizer
from financial_rag_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer
from financial_rag_tpu_torch.tokenizer.vocab import load_vocab, default_vocab_path

__all__ = ["HFTokenizer", "WordPieceTokenizer", "load_vocab", "default_vocab_path"]
