"""A reader for HuggingFace ``tokenizer.json`` files, for the decoder.

The machine with the GPU has neither ``tokenizers`` nor ``regex``, so the
port reads the file itself with the standard library. It implements what
``tokenizers`` does for three families of files:

- WordLevel with ``unk_token`` behind the ``Whitespace`` pre-tokenizer
  (the regex ``\\w+|[^\\w\\s]+``), no normalizer and no decoder: decoding
  joins the tokens with one space (the files this repository writes);
- byte-level BPE (Qwen2, Llama-3, GPT-2): an ``NFC`` normalizer or none;
  a ``Split`` pre-tokenizer on a regex with ``Isolated`` behaviour followed
  by ``ByteLevel(use_regex=false)``, or ``ByteLevel(use_regex=true)`` with
  GPT-2's pattern; BPE merges by rank, ``ignore_merges`` honoured; the
  ``ByteLevel`` decoder (bytes decoded as UTF-8 with replacement);
- SentencePiece-style BPE (Llama-2, Mistral): ``byte_fallback`` to the
  ``<0x00>``-``<0xFF>`` tokens, ``unk_token`` and ``fuse_unk``; a
  ``Prepend("▁")`` + ``Replace(" ", "▁")`` normalizer or a ``Metaspace``
  pre-tokenizer; the ``Replace`` / ``ByteFallback`` / ``Fuse`` / ``Strip``
  decoder chain.

``added_tokens`` are matched before pre-tokenization (leftmost, longest
first): the ``normalized: false`` ones in the raw text, then the text
between them is normalized and the others matched in it. Only added tokens
flagged ``special`` are dropped by ``skip_special_tokens``. A
``TemplateProcessing`` post-processor adds its special tokens around a
single sequence when ``add_special_tokens`` is true (the default, as in
``tokenizers``); a ``ByteLevel`` one leaves the ids alone.

Regex patterns are written for Oniguruma, which Python's ``re`` does not
read as is: ``\\p{..}`` general categories and ``\\s`` / ``\\S`` (Unicode
White_Space, which excludes ``\\x1c``-``\\x1f`` where Python's ``\\s``
includes them) become explicit character classes, once, at load. Scoped
flags and possessive quantifiers are Python 3.11+ syntax already.

Any other model, normalizer, pre-tokenizer, post-processor or decoder type
or option raises NotImplementedError naming it.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

_WHITESPACE = re.compile(r"\w+|[^\w\s]+")
# GPT-2's pattern, which ByteLevel(use_regex=true) splits with
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
# Unicode's White_Space property: what Oniguruma's \s matches
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
                "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
# the BPE word cache: its capacity, and the longest word it keeps (as in
# tokenizers: a SentencePiece-style file has no pre-tokenizer, so a whole
# prompt is one word)
_CACHE_WORDS = 10_000
_CACHE_CHARS = 256


class Encoding(NamedTuple):
    ids: List[int]
    tokens: List[str]


def _unsupported(what: str, spec) -> NotImplementedError:
    kind = spec.get("type", spec) if isinstance(spec, dict) else spec
    return NotImplementedError(f"tokenizer.json {what} {kind!r} is not supported")


# ------------------------------------------------------------- byte level

@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Tuple[str, ...]:
    """GPT-2's table: byte b -> the printable character that stands for it."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return tuple(table[b] for b in range(256))


@functools.lru_cache(maxsize=None)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in enumerate(bytes_to_unicode())}


def _byte_level(piece: str) -> str:
    table = bytes_to_unicode()
    return "".join([table[b] for b in piece.encode("utf-8")])


# ------------------------------------------------------------ the regexes

def _class_body(ranges, bmp: bool) -> str:
    """Sorted, disjoint [lo, hi] code point ranges -> the inside of a [...]
    class (only the ones below U+10000 where ``bmp``)."""
    def esc(cp):
        return f"\\U{cp:08x}"
    out = []
    for lo, hi in ranges:
        if bmp:
            if lo > 0xFFFF:
                break
            hi = min(hi, 0xFFFF)
        out.append(esc(lo) if lo == hi else f"{esc(lo)}-{esc(hi)}")
    return "".join(out)


def _ranges(cps) -> List[List[int]]:
    out: List[List[int]] = []
    for cp in cps:
        if out and cp == out[-1][1] + 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return out


@functools.lru_cache(maxsize=None)
def _categories() -> Dict[str, List[List[int]]]:
    """Every general category's code point ranges, in one pass."""
    cats: Dict[str, List[int]] = {}
    for cp in range(sys.maxunicode + 1):
        cats.setdefault(unicodedata.category(chr(cp)), []).append(cp)
    return {cat: _ranges(cps) for cat, cps in cats.items()}


@functools.lru_cache(maxsize=None)
def _category_class(name: str, bmp: bool) -> str:
    """The class body of the general category ``name`` (``L``, ``Lu``...)."""
    if not re.fullmatch(r"[A-Z][a-z]?", name):
        raise NotImplementedError(f"tokenizer.json regex: \\p{{{name}}} is not supported "
                                  f"(general categories only)")
    merged: List[List[int]] = []
    for lo, hi in sorted(r for cat, rs in _categories().items() if cat.startswith(name)
                         for r in rs):
        if merged and lo == merged[-1][1] + 1:
            merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return _class_body(merged, bmp)


def _ws_body() -> str:
    return _class_body(_ranges(sorted(map(ord, _WHITE_SPACE))), bmp=False)


def translate_pattern(pattern: str, bmp: bool = False) -> str:
    """An Oniguruma pattern (as tokenizers reads it) -> the same pattern for
    Python's ``re``: ``\\p{X}``, ``\\P{X}``, ``\\s`` and ``\\S`` become
    explicit classes, in and out of ``[...]``. With ``bmp`` the classes keep
    only their code points below U+10000: the pattern is then exact on text
    without astral characters, and several times faster there, since ``re``
    tests a class's astral ranges one by one."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e in "pP" and pattern[i + 2: i + 3] == "{":
                end = pattern.index("}", i)
                body = _category_class(pattern[i + 3: end], bmp)
                if in_class and e == "P":
                    raise NotImplementedError("tokenizer.json regex: \\P{..} inside [...]")
                out.append(body if in_class else f"[{'^' if e == 'P' else ''}{body}]")
                i = end + 1
                continue
            if e in "sS":
                if in_class and e == "S":
                    raise NotImplementedError("tokenizer.json regex: \\S inside [...]")
                out.append(_ws_body() if in_class else f"[{'^' if e == 'S' else ''}{_ws_body()}]")
                i += 2
                continue
            out.append(pattern[i: i + 2])
            i += 2
            continue
        if c == "[":
            in_class = True
        elif c == "]":
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


class _Regex(NamedTuple):
    full: "re.Pattern"
    bmp: "re.Pattern"     # the same on text below U+10000

    def finditer(self, text: str):
        return (self.bmp if not text or max(text) <= "\uffff" else self.full).finditer(text)


@functools.lru_cache(maxsize=32)
def _compile(pattern: str) -> _Regex:
    return _Regex(re.compile(translate_pattern(pattern)),
                  re.compile(translate_pattern(pattern, bmp=True)))


def _split_isolated(pattern, text: str) -> List[str]:
    """Every match and every gap between matches, in order."""
    out, pos = [], 0
    for m in pattern.finditer(text):
        if m.start() == m.end():
            continue
        if m.start() > pos:
            out.append(text[pos: m.start()])
        out.append(m.group(0))
        pos = m.end()
    if pos < len(text):
        out.append(text[pos:])
    return out


# ------------------------------------------------------------ normalizers

def _normalizers(spec) -> List[Callable[[str], str]]:
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for s in spec["normalizers"] for f in _normalizers(s)]
    if kind == "NFC":
        return [lambda s: unicodedata.normalize("NFC", s)]
    if kind == "Prepend":
        prefix = spec["prepend"]
        return [lambda s: prefix + s if s else s]
    if kind == "Replace":
        pat = spec.get("pattern") or {}
        if "String" not in pat:
            raise _unsupported("normalizer Replace pattern", pat)
        old, new = pat["String"], spec["content"]
        return [lambda s: s.replace(old, new)]
    raise _unsupported("normalizer", spec)


# --------------------------------------------------------- pre-tokenizers

# one step: (pieces, whether the first piece starts the input) -> pieces
PreStep = Callable[[List[str], bool], List[str]]


def _pre_tokenizers(spec) -> List[PreStep]:
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for s in spec["pretokenizers"] for f in _pre_tokenizers(s)]
    if kind == "Whitespace":
        return [lambda pieces, first: [w for p in pieces for w in _WHITESPACE.findall(p)]]
    if kind == "Split":
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise NotImplementedError(f"tokenizer.json pre_tokenizer Split with behavior "
                                      f"{spec.get('behavior')!r}, invert {spec.get('invert')!r} "
                                      f"is not supported (Isolated, invert false)")
        if "Regex" not in (spec.get("pattern") or {}):
            raise _unsupported("pre_tokenizer Split pattern", spec.get("pattern"))
        pattern = _compile(spec["pattern"]["Regex"])
        return [lambda pieces, first: [w for p in pieces for w in _split_isolated(pattern, p)]]
    if kind == "ByteLevel":
        if spec.get("add_prefix_space"):
            raise NotImplementedError("tokenizer.json pre_tokenizer ByteLevel with "
                                      "add_prefix_space true is not supported")
        gpt2 = _compile(GPT2_PATTERN) if spec.get("use_regex", True) else None
        mapped: Dict[str, str] = {}      # piece -> its byte-level characters

        def byte_level(pieces, first):
            if gpt2 is not None:
                pieces = [w for p in pieces for w in _split_isolated(gpt2, p)]
            out = []
            for p in pieces:
                m = mapped.get(p)
                if m is None:
                    m = _byte_level(p)
                    if len(mapped) < _CACHE_WORDS and len(p) < _CACHE_CHARS:
                        mapped[p] = m
                out.append(m)
            return out
        return [byte_level]
    if kind == "Metaspace":
        rep, scheme, split = spec["replacement"], spec.get("prepend_scheme"), spec["split"]
        if scheme not in ("always", "first"):
            raise _unsupported("pre_tokenizer Metaspace prepend_scheme", scheme)

        def metaspace(pieces, first):
            out = []
            for n, p in enumerate(pieces):
                p = p.replace(" ", rep)
                if not p.startswith(rep) and (scheme == "always"
                                              or (scheme == "first" and first and n == 0)):
                    p = rep + p
                out.extend([w for w in re.split(f"(?={re.escape(rep)})", p) if w]
                           if split else [p])
            return out
        return [metaspace]
    raise _unsupported("pre_tokenizer", spec)


# --------------------------------------------------------------- decoders

def _decoders(spec) -> List[Callable[[List[str]], List[str]]]:
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for s in spec["decoders"] for f in _decoders(s)]
    if kind == "ByteLevel":
        return [_decode_byte_level]
    if kind == "Replace":
        pat = spec.get("pattern") or {}
        if "String" not in pat:
            raise _unsupported("decoder Replace pattern", pat)
        old, new = pat["String"], spec["content"]
        return [lambda toks: [t.replace(old, new) for t in toks]]
    if kind == "ByteFallback":
        return [_decode_byte_fallback]
    if kind == "Fuse":
        return [lambda toks: ["".join(toks)]]
    if kind == "Strip":
        content, start, stop = spec["content"], int(spec["start"]), int(spec["stop"])
        return [lambda toks: [_strip(t, content, start, stop) for t in toks]]
    raise _unsupported("decoder", spec)


def _decode_byte_level(toks: List[str]) -> List[str]:
    """Each token's characters back to bytes (a token with a character
    outside the table keeps its own UTF-8), decoded with replacement."""
    back = _unicode_to_bytes()
    raw = bytearray()
    for t in toks:
        try:
            raw.extend([back[c] for c in t])
        except KeyError:
            raw.extend(t.encode("utf-8"))
    return [raw.decode("utf-8", errors="replace")]


def _byte_token(tok: str) -> Optional[int]:
    if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
        try:
            return int(tok[3:5], 16)
        except ValueError:
            return None
    return None


def _decode_byte_fallback(toks: List[str]) -> List[str]:
    """Runs of <0xXX> tokens -> their UTF-8 text, or one U+FFFD a byte
    where the run is not valid UTF-8."""
    out, run = [], bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend(["�"] * len(run))
            run.clear()
    for t in toks:
        b = _byte_token(t)
        if b is not None:
            run.append(b)
            continue
        flush()
        out.append(t)
    flush()
    return out


def _strip(tok: str, content: str, start: int, stop: int) -> str:
    lo = 0
    while lo < min(start, len(tok)) and tok[lo] == content:
        lo += 1
    hi = len(tok)
    for _ in range(stop):
        if hi > lo and tok[hi - 1] == content:
            hi -= 1
        else:
            break
    return tok[lo:hi]


# ---------------------------------------------------------------- models

class _WordLevel:
    def __init__(self, model: dict) -> None:
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.unk_token = model.get("unk_token")

    def tokenize(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk_token is None or self.unk_token not in self.vocab:
            raise ValueError(f"WordLevel: {word!r} is not in the vocabulary and there is "
                             f"no unk_token in it")
        return [self.vocab[self.unk_token]]


class _BPE:
    """tokenizers' BPE without dropout: characters (or their UTF-8 byte
    tokens, or the unknown token) merged pair by pair, lowest rank first
    and leftmost among equals, with a per-word cache."""

    def __init__(self, model: dict) -> None:
        if model.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError(f"tokenizer.json BPE dropout {model['dropout']!r} "
                                      f"is not supported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key) is not None:
                raise NotImplementedError(f"tokenizer.json BPE {key} {model[key]!r} "
                                          f"is not supported")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.unk_token = model.get("unk_token")
        self.fuse_unk = bool(model.get("fuse_unk"))
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.ignore_merges = bool(model.get("ignore_merges"))
        # (left id, right id) -> (rank, merged id); "a b" strings or [a, b] pairs
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            for part in (a, b, a + b):
                if part not in self.vocab:
                    raise ValueError(f"BPE merge {a!r} {b!r}: {part!r} is not in the vocabulary")
            self.merges[self.vocab[a], self.vocab[b]] = (rank, self.vocab[a + b])
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[int]:
        syms: List[int] = []
        unk: Optional[int] = None       # a pending unknown token (fused if fuse_unk)
        unk_id = self.vocab.get(self.unk_token) if self.unk_token is not None else None
        for c in word:
            i = self.vocab.get(c)
            if i is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(i)
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in c.encode("utf-8")]
                if all(i is not None for i in ids):
                    syms.extend(ids)       # a pending unknown token stays pending
                    continue
            if unk_id is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = unk_id
        if unk is not None:
            syms.append(unk)
        return syms

    def _merge(self, syms: List[int]) -> List[int]:
        n = len(syms)
        if n < 2:
            return syms
        merges = self.merges
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j < 0:
                continue
            m = merges.get((syms[i], syms[j]))
            if m is None or m[1] != new:
                continue                 # this pair changed since it was queued
            syms[i] = new
            alive[j] = False
            k = nxt[j]
            nxt[i] = k
            if k >= 0:
                prev[k] = i
                m = merges.get((new, syms[k]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
            p = prev[i]
            if p >= 0:
                m = merges.get((syms[p], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
        return [s for s, a in zip(syms, alive) if a]

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = self._merge(self._symbols(word))
        if len(self._cache) < _CACHE_WORDS and len(word) < _CACHE_CHARS:
            self._cache[word] = ids
        return ids


_MODELS = {"WordLevel": _WordLevel, "BPE": _BPE}


# -------------------------------------------------------- post-processors

def _template(spec) -> Tuple[List[Tuple[int, str]], List[Tuple[int, str]]]:
    """(ids and tokens before, after) the sequence that a single-sequence
    post-processor adds."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind == "ByteLevel":
        return [], []
    if kind == "Sequence":
        before, after = [], []
        for s in spec["processors"]:
            b, a = _template(s)
            before, after = b + before, after + a
        return before, after
    if kind != "TemplateProcessing":
        raise _unsupported("post_processor", spec)
    before, after, seen = [], [], False
    for item in spec["single"]:
        if "Sequence" in item:
            if item["Sequence"]["id"] != "A" or seen:
                raise _unsupported("post_processor TemplateProcessing single", spec["single"])
            seen = True
            continue
        special = spec["special_tokens"][item["SpecialToken"]["id"]]
        (after if seen else before).extend(zip(special["ids"], special["tokens"]))
    return before, after


# ------------------------------------------------------------- tokenizer

class HFTokenizer:
    """``encode`` and ``decode`` of a ``tokenizer.json`` (see the module)."""

    def __init__(self, spec: dict) -> None:
        model = spec.get("model") or {}
        if model.get("type") not in _MODELS:
            raise NotImplementedError(f"tokenizer.json model type {model.get('type')!r} "
                                      f"is not supported (WordLevel or BPE)")
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, spec[key])
        self.model = _MODELS[model["type"]](model)
        self.vocab: Dict[str, int] = self.model.vocab
        self._normalize = _normalizers(spec.get("normalizer"))
        self._pre = _pre_tokenizers(spec.get("pre_tokenizer"))
        self._decode = _decoders(spec["decoder"]) if spec.get("decoder") else None
        self._before, self._after = _template(spec.get("post_processor"))
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
        self._raw_split, self._norm_split = (
            re.compile("|".join(re.escape(t) for t in sorted(group, key=len, reverse=True)))
            if group else None for group in (raw, normalized))
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})

    @classmethod
    def from_file(cls, path: str | Path) -> "HFTokenizer":
        return cls(json.loads(Path(path).read_text(encoding="utf-8")))

    @staticmethod
    def _split_added(pieces, pattern):
        if pattern is None:
            return pieces
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
        return out

    def _pieces(self, text: str):
        """[(piece, is_added)]: the added tokens, and the normalized text
        between them."""
        pieces = self._split_added([(text, False)], self._raw_split)
        if self._normalize:
            normed = []
            for piece, added in pieces:
                if not added:
                    for f in self._normalize:
                        piece = f(piece)
                normed.append((piece, added))
            pieces = normed
        return self._split_added(pieces, self._norm_split)

    def encode(self, text: str, add_special_tokens: bool = True) -> Encoding:
        ids: List[int] = []
        for n, (piece, added) in enumerate(self._pieces(text)):
            if added:
                ids.append(self.added[piece])
                continue
            words = [piece]
            for step in self._pre:
                words = step(words, n == 0)
            for word in words:
                ids.extend(self.model.tokenize(word))
        tokens = [self.id_to_token[i] for i in ids]
        if add_special_tokens and (self._before or self._after):
            ids = [i for i, _ in self._before] + ids + [i for i, _ in self._after]
            tokens = [t for _, t in self._before] + tokens + [t for _, t in self._after]
        return Encoding(ids, tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = [self.id_to_token[i] for i in ids if i in self.id_to_token]
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.special]
        if self._decode is None:
            return " ".join(toks)
        for step in self._decode:
            toks = step(toks)
        return "".join(toks)
