"""Two-tier parent/child chunker.

Behavioral contract of the reference chunker (reference
parent_child/parent_child_chunker.py:101-235):

- HTML-aware normalization: <br> and closing block tags become newlines,
  remaining tags stripped, entities unescaped, whitespace collapsed;
- heuristic token count = word count x 1.3;
- PARENTS: consecutive page blocks packed until parent_max_tokens (default
  1500), joined with newlines, carrying page_start/page_end;
- CHILDREN: per parent, sentence-accumulation up to child_max_tokens
  (default 300) with a trailing word overlap (default 80 words); if that
  yields <=1 chunk or an oversized chunk (tables/lists), a line/window pass
  with the same overlap; if that yields nothing, hard word windows.

IDs are snowflakes; embeddings are NOT attached here — the pipeline embeds
children in large device batches (the reference's optional fused-embedding
chunker path is provided by DualEncoder.encode_fused instead).
"""

from __future__ import annotations

import bisect
import html as html_mod
import re

import numpy as np
from dataclasses import dataclass
from typing import List, Optional

from financial_rag_tpu_torch.config import ChunkingConfig
from financial_rag_tpu_torch.store.snowflake import SnowflakeGenerator

_WORD_RE = re.compile(r"\w+")
_BR_RE = re.compile(r"<\s*br\s*/?>", re.IGNORECASE)
_BLOCK_CLOSE_RE = re.compile(r"</\s*(p|div|tr|table|h\d)\s*>", re.IGNORECASE)
_TAG_RE = re.compile(r"<[^>]+>")
_SENT_SPLIT_RE = re.compile(r"[.!?]\s+")


@dataclass
class ParentChunk:
    parent_id: int
    document_id: str
    content: str
    page_start: int
    page_end: int
    token_count: int = 0


@dataclass
class ChildChunk:
    child_id: int
    parent_id: int
    content: str
    context: Optional[str] = None
    token_count: int = 0


def normalize_text(text: str) -> str:
    if "<" in text and ">" in text:
        t = _BR_RE.sub("\n", text)
        t = _BLOCK_CLOSE_RE.sub("\n", t)
        t = _TAG_RE.sub(" ", t)
        t = html_mod.unescape(t)
    else:
        t = text
    t = re.sub(r"[ \t\r\f]+", " ", t)
    t = re.sub(r"\n\s*\n+", "\n", t)
    return t.strip()


_NATIVE = None


def _native():
    """(word_count, word_starts) C++ fast path for ASCII text, or None.
    Exact: for ASCII, \\w is [A-Za-z0-9_] and byte == char offsets."""
    global _NATIVE
    if _NATIVE is None:
        try:
            from financial_rag_tpu_torch.native import (
                available, native_word_count, native_word_starts)

            _NATIVE = (native_word_count, native_word_starts) if available() else False
        except Exception:  # pragma: no cover — toolchain-less environments
            _NATIVE = False
    return _NATIVE or None


def word_count(text: str) -> int:
    nat = _native()
    if nat is not None and text.isascii():
        return nat[0](text.encode())
    return len(_WORD_RE.findall(text))


def token_estimate(text: str) -> int:
    return int(word_count(text) * 1.3)


def _tokens_of_words(n_words: int) -> int:
    """token_estimate for a known word count. `\\w+` matches never span
    whitespace, so word counts are additive across space/newline joins:
    word_count(a + " " + b) == word_count(a) + word_count(b). The
    accumulation passes below exploit this to keep chunking O(text)
    instead of re-scanning the growing buffer per sentence/line (the
    re-scan was ~70% of ingest host time at 200-child documents)."""
    return int(n_words * 1.3)


class ParentChildChunker:
    def __init__(self, config: Optional[ChunkingConfig] = None,
                 id_gen: Optional[SnowflakeGenerator] = None) -> None:
        self.cfg = config or ChunkingConfig()
        self.id_gen = id_gen or SnowflakeGenerator()

    # ------------------------------------------------------------- parents

    def make_parents(self, blocks: List[dict], document_id: str) -> List[ParentChunk]:
        parents: List[ParentChunk] = []
        buf: List[str] = []
        acc = 0
        page_start: Optional[int] = None
        page_end: Optional[int] = None

        words_acc = 0

        def emit():
            nonlocal buf, acc
            content = "\n".join(buf).strip()
            if content:
                parents.append(ParentChunk(
                    parent_id=self.id_gen.next_id(),
                    document_id=document_id,
                    content=content,
                    page_start=page_start or 0,
                    page_end=page_end if page_end is not None else (page_start or 0),
                    # strip() of a newline-join removes no words
                    token_count=_tokens_of_words(words_acc),
                ))

        for b in blocks:
            text = normalize_text(b.get("content") or b.get("html") or "")
            if not text:
                continue
            page = int(b.get("page", 0) or 0)
            wc = word_count(text)
            tlen = _tokens_of_words(wc)
            if page_start is None:
                page_start = page
            if acc + tlen > self.cfg.parent_max_tokens and buf:
                emit()
                buf, acc, words_acc = [text], tlen, wc
                page_start = page_end = page
            else:
                buf.append(text)
                acc += tlen
                words_acc += wc
                page_end = page
        if buf:
            emit()
        return parents

    # ------------------------------------------------------------ children

    def split_child_texts(self, text: str) -> List[str]:
        return [c for c, _ in self.split_child_counted(text)]

    def split_child_counted(self, text: str) -> List[tuple]:
        """(chunk, word_count(chunk)) pairs: every pass carries the counts
        it already maintained, so no chunk is re-scanned afterwards."""
        def oversized(cs: List[tuple]) -> bool:
            return bool(cs) and max(_tokens_of_words(w) for _, w in cs) \
                > int(self.cfg.child_max_tokens * 0.9)

        chunks = self._sentence_pass_counted(text)
        if len(chunks) <= 1 or oversized(chunks):
            line_chunks = self._line_window_pass_counted(text)
            # a single-line blob defeats the line pass too; hard windows are
            # the guaranteed splitter (goes beyond the reference, which
            # returns one oversized chunk here)
            if not line_chunks or (len(line_chunks) <= 1 and oversized(line_chunks)
                                   and token_estimate(text) > self.cfg.child_max_tokens):
                line_chunks = self._hard_window_pass_counted(text)
            if line_chunks:
                chunks = line_chunks
        return [cw for cw in chunks if cw[0]]

    @staticmethod
    def _sentences_with_counts(text: str):
        """Split into sentences with per-sentence word counts from ONE scan
        of the text. `\\w+` matches contain no `.!?` or whitespace, so every
        word lies entirely inside one split segment — counting word starts
        per segment interval equals word_count(segment)."""
        segs = []
        prev = 0
        for m in _SENT_SPLIT_RE.finditer(text):
            segs.append((prev, m.start()))
            prev = m.end()
        segs.append((prev, len(text)))

        nat = _native()
        if nat is not None and text.isascii():
            starts = nat[1](text.encode())
            bounds = np.asarray(segs, np.int64)
            lo = np.searchsorted(starts, bounds[:, 0])
            hi = np.searchsorted(starts, bounds[:, 1])
            counts = (hi - lo).tolist()
        else:
            word_starts = [m.start() for m in _WORD_RE.finditer(text)]
            counts = [bisect.bisect_left(word_starts, e) - bisect.bisect_left(word_starts, s)
                      for s, e in segs]
        out = []
        for (s, e), c in zip(segs, counts):
            sent = text[s:e]
            if sent:
                out.append((sent, c))
        return out

    def _sentence_pass(self, text: str) -> List[str]:
        return [c for c, _ in self._sentence_pass_counted(text)]

    def _sentence_pass_counted(self, text: str) -> List[tuple]:
        out: List[tuple] = []
        cur = ""
        cur_wc = 0  # word_count(cur), maintained incrementally
        for sent, wc in self._sentences_with_counts(text):
            merged_wc = wc if not cur else cur_wc + wc
            if _tokens_of_words(merged_wc) > self.cfg.child_max_tokens and cur:
                out.append((cur.strip(), cur_wc))  # strip removes no words
                tail = cur.split()[-self.cfg.child_overlap_words:]
                cur = (" ".join(tail) + " " + sent).strip()
                # overlap tail re-splits on whitespace (not \w+), so its
                # word count is not derivable from counters — rescan the
                # bounded tail+sentence only
                cur_wc = word_count(cur)
            else:
                cur = sent if not cur else f"{cur} {sent}"
                cur_wc = merged_wc
        if cur:
            out.append((cur.strip(), cur_wc))
        return [cw for cw in out if cw[0]]

    def _line_window_pass(self, text: str) -> List[str]:
        return [c for c, _ in self._line_window_pass_counted(text)]

    def _line_window_pass_counted(self, text: str) -> List[tuple]:
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        out: List[tuple] = []
        buf: List[str] = []
        acc = 0
        buf_wc = 0  # word_count of the joined buffer
        for ln in lines:
            wc = word_count(ln)
            tlen = _tokens_of_words(wc)
            if acc + tlen > self.cfg.child_max_tokens and buf:
                win = "\n".join(buf).strip()
                out.append((win, buf_wc))
                tail = win.split()[-self.cfg.child_overlap_words:]
                buf = [" ".join(tail), ln]
                tail_wc = word_count(buf[0])
                acc = _tokens_of_words(tail_wc) + tlen
                buf_wc = tail_wc + wc
            else:
                buf.append(ln)
                acc += tlen
                buf_wc += wc
        if buf:
            out.append(("\n".join(buf).strip(), buf_wc))
        return [cw for cw in out if cw[0]]

    def _hard_window_pass(self, text: str) -> List[str]:
        return [c for c, _ in self._hard_window_pass_counted(text)]

    def _hard_window_pass_counted(self, text: str) -> List[tuple]:
        words = text.split()
        step = max(self.cfg.child_max_tokens - self.cfg.child_overlap_words, 1)
        out = []
        for i in range(0, len(words), step):
            win = words[i: i + self.cfg.child_max_tokens]
            if win:
                c = " ".join(win)
                out.append((c, word_count(c)))
        return out

    def make_children(self, parents: List[ParentChunk]) -> List[ChildChunk]:
        children: List[ChildChunk] = []
        for p in parents:
            for text, wc in self.split_child_counted(p.content):
                children.append(ChildChunk(
                    child_id=self.id_gen.next_id(),
                    parent_id=p.parent_id,
                    content=text,
                    token_count=_tokens_of_words(wc),
                ))
        return children

    def chunk(self, blocks: List[dict], document_id: str):
        parents = self.make_parents(blocks, document_id)
        children = self.make_children(parents)
        return parents, children
