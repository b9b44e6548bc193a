"""Vocabulary loading.

The framework vendors the standard bert-base-uncased vocabulary (public model
data shared by all three reference checkpoints, see assets/README.md); a
custom `vocab.txt` path — e.g. a model directory — is also accepted.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, List

_ASSET = Path(__file__).resolve().parent.parent / "assets" / "bert_uncased_vocab.txt.gz"


def default_vocab_path() -> Path:
    return _ASSET


def load_vocab(path: str | Path | None = None) -> Dict[str, int]:
    """Load a WordPiece vocab file (token per line) into token -> id."""
    p = Path(path) if path is not None else _ASSET
    if p.is_dir():
        p = p / "vocab.txt"
    if str(p).endswith(".gz"):
        with gzip.open(p, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
    else:
        with open(p, encoding="utf-8") as f:
            lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return {tok: i for i, tok in enumerate(lines)}


def inverse_vocab(vocab: Dict[str, int]) -> List[str]:
    inv = [""] * (max(vocab.values()) + 1)
    for tok, i in vocab.items():
        inv[i] = tok
    return inv
