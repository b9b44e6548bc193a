"""A reader for HuggingFace ``tokenizer.json`` files, for the decoder.

The machine with the GPU has no ``tokenizers`` package, so the port reads
the file itself. It implements exactly what ``tokenizers`` does for the
files this repository writes and serves:

- model ``WordLevel`` with ``unk_token``;
- pre-tokenizer ``Whitespace`` (the regex ``\\w+|[^\\w\\s]+``);
- ``added_tokens``, matched in the raw text before pre-tokenization
  (leftmost, longest first; the ``normalized: false`` ones first), with
  their ``special`` flag for ``skip_special_tokens``;
- ``normalizer``, ``post_processor`` and ``decoder`` null: decoding joins
  the tokens with one space, and drops ids the vocabulary does not hold.

Any other model, pre-tokenizer, normalizer, post-processor or decoder type
raises NotImplementedError naming it. Byte-level BPE (the real Qwen2
tokenizer) is a later step of the port.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

_WHITESPACE = re.compile(r"\w+|[^\w\s]+")


class Encoding(NamedTuple):
    ids: List[int]
    tokens: List[str]


class HFTokenizer:
    """``encode`` and ``decode`` of a WordLevel ``tokenizer.json``."""

    def __init__(self, spec: dict) -> None:
        model = spec.get("model") or {}
        if model.get("type") != "WordLevel":
            raise NotImplementedError(f"tokenizer.json model type {model.get('type')!r} "
                                      f"is not supported (WordLevel only)")
        pre = spec.get("pre_tokenizer")
        if (pre or {}).get("type") != "Whitespace":
            raise NotImplementedError(f"tokenizer.json pre_tokenizer "
                                      f"{(pre or {}).get('type')!r} is not supported "
                                      f"(Whitespace only)")
        for key in ("normalizer", "post_processor", "decoder", "truncation", "padding"):
            if spec.get(key) is not None:
                kind = spec[key].get("type", spec[key]) if isinstance(spec[key], dict) else spec[key]
                raise NotImplementedError(f"tokenizer.json {key} {kind!r} is not supported")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.unk_token = model.get("unk_token")
        self.added: Dict[str, int] = {}
        self.special = set()    # contents of the special added tokens
        raw, normalized = [], []
        for tok in spec.get("added_tokens") or []:
            for flag in ("single_word", "lstrip", "rstrip"):
                if tok.get(flag):
                    raise NotImplementedError(f"added token {tok['content']!r}: "
                                              f"{flag} is not supported")
            self.added[tok["content"]] = int(tok["id"])
            if tok.get("special"):
                self.special.add(tok["content"])
            (normalized if tok.get("normalized", True) else raw).append(tok["content"])
        # alternation tries longer contents first: leftmost, then longest
        self._splits = [re.compile("|".join(re.escape(t) for t in sorted(group, key=len,
                                                                          reverse=True)))
                        for group in (raw, normalized) if group]
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})

    @classmethod
    def from_file(cls, path: str | Path) -> "HFTokenizer":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    def _pieces(self, text: str):
        """[(piece, is_added)] after the added-token splits, in order."""
        pieces = [(text, False)]
        for pattern in self._splits:
            out = []
            for piece, added in pieces:
                if added:
                    out.append((piece, True))
                    continue
                pos = 0
                for m in pattern.finditer(piece):
                    if m.start() > pos:
                        out.append((piece[pos:m.start()], False))
                    out.append((m.group(0), True))
                    pos = m.end()
                if pos < len(piece):
                    out.append((piece[pos:], False))
            pieces = out
        return pieces

    def _word_id(self, word: str) -> int:
        if word in self.vocab:
            return self.vocab[word]
        if self.unk_token is None or self.unk_token not in self.vocab:
            raise ValueError(f"WordLevel: {word!r} is not in the vocabulary and there is "
                             f"no unk_token in it")
        return self.vocab[self.unk_token]

    def encode(self, text: str) -> Encoding:
        ids: List[int] = []
        tokens: List[str] = []
        for piece, added in self._pieces(text):
            if added:
                ids.append(self.added[piece])
                tokens.append(piece)
                continue
            for word in _WHITESPACE.findall(piece):
                i = self._word_id(word)
                ids.append(i)
                tokens.append(self.id_to_token[i])
        return Encoding(ids, tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = [self.id_to_token[i] for i in ids if i in self.id_to_token]
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.special]
        return " ".join(toks)
