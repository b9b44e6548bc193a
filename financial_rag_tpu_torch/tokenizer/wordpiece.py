"""Exact HF-compatible BERT WordPiece tokenizer (host side).

The reference's local fallback tokenizer is a toy whitespace splitter
(reference local_embedder.py:24-84) that destroys recall parity; SURVEY.md
§3.5/§7.3 requires true WordPiece matching HuggingFace `BertTokenizer` for
the bundled checkpoints. This implementation reproduces the BasicTokenizer +
WordPiece greedy longest-match algorithm bit-for-bit (verified against
`transformers.BertTokenizer` in tests/test_tokenizer.py).

A C++ batch fast path lives in financial_rag_tpu_torch/native (loaded
lazily); this module is the always-available pure-Python reference
implementation.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from financial_rag_tpu_torch.tokenizer.vocab import load_vocab

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
MAX_WORD_CHARS = 100


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """Pre-tokenization: cleaning, CJK isolation, lowercasing, accent
    stripping, punctuation splitting — semantics of HF BertTokenizer's
    BasicTokenizer with the reference checkpoints' settings
    (do_lower_case=True, strip_accents=None, tokenize_chinese_chars=True)."""

    def __init__(self, do_lower_case: bool = True, strip_accents: Optional[bool] = None,
                 never_split: Optional[Sequence[str]] = None):
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.never_split = set(never_split or ())

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._isolate_cjk(text)
        # NFC normalization (HF >=4.31 behavior)
        text = unicodedata.normalize("NFC", text)
        out: List[str] = []
        for tok in text.split():
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                if self.strip_accents is not False:
                    tok = self._strip_accents(tok)
            elif self.strip_accents:
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        buf = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            buf.append(" " if _is_whitespace(ch) else ch)
        return "".join(buf)

    @staticmethod
    def _isolate_cjk(text: str) -> str:
        buf = []
        for ch in text:
            if _is_cjk(ord(ch)):
                buf.append(f" {ch} ")
            else:
                buf.append(ch)
        return "".join(buf)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    def _split_punct(self, tok: str) -> List[str]:
        if tok in self.never_split:
            return [tok]
        out: List[List[str]] = []
        start_new = True
        for ch in tok:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(g) for g in out]


class WordPieceTokenizer:
    """Full tokenizer: BasicTokenizer + greedy longest-match WordPiece,
    plus batched fixed-shape encoding for the device encoder."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 vocab_path: Optional[str] = None,
                 do_lower_case: bool = True,
                 use_native: bool = True):
        self.vocab = vocab if vocab is not None else load_vocab(vocab_path)
        special = [PAD, UNK, CLS, SEP, MASK]
        self.basic = BasicTokenizer(do_lower_case=do_lower_case, never_split=special)
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        # C++ fast path for plain-ASCII text (exact for that subset); lazily
        # constructed, silently absent when the toolchain/library is missing
        self._native = None
        self._native_ok = use_native and do_lower_case

    def _native_tok(self):
        if not self._native_ok:
            return None
        if self._native is None:
            try:
                from financial_rag_tpu_torch.native import NativeWordPiece, available
                from financial_rag_tpu_torch.tokenizer.vocab import inverse_vocab

                if available():
                    self._native = NativeWordPiece(inverse_vocab(self.vocab))
                else:
                    self._native_ok = False
            except Exception:
                self._native_ok = False
        return self._native

    @staticmethod
    def _native_safe(text: str) -> bool:
        # native path handles pure-ASCII text without special-token literals
        return text.isascii() and "[" not in text

    def token_ids(self, text: str) -> List[int]:
        """Raw WordPiece ids (no CLS/SEP), using the C++ path when exact."""
        native = self._native_tok()
        if native is not None and self._native_safe(text):
            return native.tokenize_ids(text)
        return self.convert_tokens_to_ids(self.tokenize(text))

    # --- token-level API -------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in self.basic.tokenize(text):
            if word in self.basic.never_split:
                pieces.append(word)
                continue
            pieces.extend(self._wordpiece(word))
        return pieces

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_WORD_CHARS:
            return [UNK]
        out: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            out.append(cur)
            start = end
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    # --- sequence-level API ----------------------------------------------

    def encode(self, text: str, max_len: int = 512) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_len."""
        ids = self.token_ids(text)[: max_len - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_many(self, texts: Sequence[str], max_len: int = 512) -> List[List[int]]:
        """Batch encode(): one C++ call for all ASCII-safe texts instead of
        a ctypes round trip per text (the per-text path pays ~40% of its
        time in FFI setup at child-chunk sizes); non-ASCII texts fall back
        to the exact Python path individually. Output identical to
        [self.encode(t, max_len) for t in texts]."""
        native = self._native_tok()
        out: List[Optional[List[int]]] = [None] * len(texts)
        native_idx = []
        if native is not None:
            native_idx = [i for i, t in enumerate(texts) if self._native_safe(t)]
            if native_idx:
                batches = native.tokenize_ids_batch(
                    [texts[i] for i in native_idx], max_out=max_len - 2)
                for i, ids in zip(native_idx, batches):
                    out[i] = [self.cls_id] + ids + [self.sep_id]
        for i, t in enumerate(texts):
            if out[i] is None:
                out[i] = self.encode(t, max_len=max_len)
        return out

    def encode_many_packed(self, texts: Sequence[str], max_len: int = 512):
        """Batch encode() into fixed-shape matrices: (ids [N, max_len] int32
        right-padded with pad_id, lens [N] int32 incl. CLS/SEP). ASCII-safe
        texts ride ONE native call whose output matrix is placed with
        vectorized numpy ops — no per-text Python lists anywhere; others
        take the exact per-text path. Row i equals encode(texts[i]) padded."""
        n = len(texts)
        ids = np.full((n, max_len), self.pad_id, np.int32)
        lens = np.zeros(n, np.int32)
        native = self._native_tok()
        native_idx = ([i for i, t in enumerate(texts) if self._native_safe(t)]
                      if native is not None else [])
        if native_idx:
            raw, raw_lens = native.tokenize_ids_batch_packed(
                [texts[i] for i in native_idx], max_out=max_len - 2)
            rows = np.asarray(native_idx)
            body = np.full((len(rows), max_len), self.pad_id, np.int32)
            body[:, 0] = self.cls_id
            body[:, 1: max_len - 1] = np.where(
                np.arange(max_len - 2)[None, :] < raw_lens[:, None], raw, self.pad_id)
            body[np.arange(len(rows)), raw_lens + 1] = self.sep_id
            ids[rows] = body
            lens[rows] = raw_lens + 2
        if len(native_idx) != n:
            done = set(native_idx)
            for i, t in enumerate(texts):
                if i in done:
                    continue
                s = self.encode(t, max_len=max_len)
                ids[i, : len(s)] = s
                lens[i] = len(s)
        return ids, lens

    def encode_pair(self, text_a: str, text_b: str, max_len: int = 512) -> Tuple[List[int], List[int]]:
        """[CLS] a [SEP] b [SEP] with longest-first truncation.
        Returns (ids, token_type_ids)."""
        a = self.token_ids(text_a)
        b = self.token_ids(text_b)
        budget = max_len - 3
        while len(a) + len(b) > budget:
            if len(a) >= len(b):
                a.pop()
            else:
                b.pop()
        ids = [self.cls_id] + a + [self.sep_id] + b + [self.sep_id]
        types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        return ids, types

    # --- batched fixed-shape encoding (XLA-friendly) ----------------------

    def encode_batch(self, texts: Sequence[str], max_len: int = 512,
                     pad_to: Optional[int] = None) -> dict:
        """Tokenize a batch into fixed-shape numpy arrays.

        pad_to: static sequence length for the whole batch. Defaults to the
        smallest multiple of 64 (TPU-friendly lane packing) covering the
        longest sequence, capped at max_len. Replaces the reference's
        batch-size-1 loop (reference local_embedder.py:160-184).
        """
        seqs = [self.encode(t, max_len=max_len) for t in texts]
        return self._pack(seqs, None, max_len, pad_to)

    def encode_pairs_batch(self, pairs: Sequence[Tuple[str, str]], max_len: int = 512,
                           pad_to: Optional[int] = None) -> dict:
        seqs, types = [], []
        for a, b in pairs:
            ids, tt = self.encode_pair(a, b, max_len=max_len)
            seqs.append(ids)
            types.append(tt)
        return self._pack(seqs, types, max_len, pad_to)

    def _pack(self, seqs: List[List[int]], types: Optional[List[List[int]]],
              max_len: int, pad_to: Optional[int]) -> dict:
        longest = max((len(s) for s in seqs), default=1)
        if pad_to is None:
            pad_to = min(max_len, ((longest + 63) // 64) * 64)
        pad_to = max(pad_to, 1)
        n = len(seqs)
        input_ids = np.full((n, pad_to), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((n, pad_to), dtype=np.int32)
        token_type_ids = np.zeros((n, pad_to), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = s[:pad_to]
            input_ids[i, : len(s)] = s
            attention_mask[i, : len(s)] = 1
            if types is not None:
                tt = types[i][:pad_to]
                token_type_ids[i, : len(tt)] = tt
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
        }
