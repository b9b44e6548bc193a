"""Continuous batching for streaming answer synthesis.

Counterpart of financial_rag_tpu/llm/continuous.py. Concurrent
``/search-stream`` answers share ONE batched decode loop on the serving
device, and new requests JOIN at segment boundaries instead of waiting for
the current generations to finish. A decode step streams every weight once
whatever the row count, so rows in one step share that cost.

Layout (kept from the JAX package):
- The engine owns a fixed [rows] slot batch and a shared KV cache
  [L, rows, T, KV, D] in SHARED WRITE-HEAD coordinates: every decode step
  writes every row's k/v at the same slot ``w`` (the host-tracked step
  counter), as ``models/decoder._decode_one`` does, so a step needs no
  per-row scatter.
- A joiner's prompt is prefilled on its own at its bucket (through
  ``_prefill``, so through K9 on CUDA) and its k/v copied to [w - s, w) of
  its row, right behind the write head: a row's live region (prompt and
  decode tokens) is contiguous. The row's prompt mask hides everything
  before it (the previous occupant's data) and the prompt's left padding
  (where K9 writes zeros and the JAX kernel the mean of V).
- Per-row rotary positions are kept per row, so left padding and join time
  never shift a row's rotation.
- Admission control instead of defragmentation: the shared window spends
  one slot per step, so a request with cap ``c`` is admitted only while
  ``c`` slots remain; when the engine drains empty the write head resets.
  A rejected submission returns None and the caller falls back to the
  per-request stream.

Execution. Where the JAX package jits a join, a ``lax.scan`` segment and a
speculative block, the port runs them eagerly on the engine's device: a
segment is a loop of ``_decode_one`` steps whose tokens stay on the device
until the segment ends (one device-to-host copy a segment), and a
speculative block drafts on the host (numpy prompt lookup, as the port's
batch-1 ``_Spec`` does) and verifies every row's block in one
``_verify_block_rows``. The device state (caches, prompt masks) lives on
the device; the fed-token history, positions and done flags on the host.

Greedy semantics: a joined stream's tokens equal batch-1 greedy
``generate_tokens`` output trimmed at eos, exactly in f32; under bf16 a
near-tie can resolve differently across batch shapes, as in
``generate_many`` waves. Speculative blocks (spec_k > 0) emit 1..spec_k+1
tokens per row per dispatch; the write head still advances by the whole
block, each row's rejected slots are masked out of its prompt mask, and the
host falls back to greedy segments whenever one more block could strand a
live row. Acceptance changes speed, never the tokens.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from financial_rag_tpu_torch.models.decoder import (
    _decode_one, _inputs, _pl_drafts, _prefill, _update, _verify_block_rows)
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("llm.continuous")

_CLOSED = object()          # stream sentinel: engine shut down mid-request
_REJECTED = object()        # stream sentinel: window raced away post-submit


class WindowRacedError(RuntimeError):
    """Raised by a stream iterator when the shared window raced away
    between submit()'s admission check and the worker's join. Guaranteed
    to fire BEFORE any token block is yielded, so callers may cleanly
    fall back to a per-request stream (serving/batcher.py does)."""


# ------------------------------------------------------------ device side

def _prefill_row(params, cfg):
    def prefill_row(input_ids, attention_mask):
        """(first output token, k, v [L, 1, s, KV, D]) of one LEFT-padded
        prompt: max_total == s, so the caches are exactly the prompt's."""
        ids, am = _inputs(params, input_ids, attention_mask)
        last, k_seq, v_seq = _prefill(params, ids, am, ids.shape[1], cfg)
        return int(torch.argmax(last[0])), k_seq, v_seq

    return prefill_row


class _Stream:
    __slots__ = ("q", "cap", "emitted")

    def __init__(self, cap: int) -> None:
        self.q: "queue.Queue" = queue.Queue()
        self.cap = cap
        self.emitted = 0


class ContinuousDecodeEngine:
    """Shared batched decode loop for concurrent greedy token streams.

    submit() returns an iterator of [1, n] int32 numpy token blocks (the
    same block contract as models/decoder.generate_stream) or None when the
    request cannot be admitted (window exhausted while other rows are live,
    or a prompt wider than the layout); callers fall back to their
    per-request path. A background worker owns the device state; requests
    only touch queues.
    """

    def __init__(self, params, cfg, *, rows: int = 8, t_prompt: int = 4096,
                 window: int = 2048, segment: int = 16, spec_k: int = 7,
                 ngram: int = 3) -> None:
        self.params = params
        self.cfg = cfg
        self.rows = rows
        self.t_prompt = t_prompt
        # a segment writes cache slots [w, w + segment): a window that is a
        # segment multiple keeps every step inside t_total
        window = max(segment, (window // segment) * segment)
        self.window = window
        self.segment = segment
        self.t_total = t_prompt + window
        self.ngram = ngram
        # speculative block decode (spec_k drafts + 1 fed token per
        # dispatch); disabled when the window cannot hold one block
        self.spec_k = int(spec_k)
        self.blk = self.spec_k + 1
        self._spec_fn = (self._spec_block
                         if self.spec_k > 0 and self.blk <= window else None)
        self._prefill = _prefill_row(params, cfg)
        self.device = params["embed"].device

        L = len(params["layers"])
        kv, d = cfg.num_kv_heads, cfg.head_dim
        dt = params["embed"].dtype
        with torch.inference_mode():
            self._kc = torch.zeros((L, rows, self.t_total, kv, d), dtype=dt, device=self.device)
            self._vc = torch.zeros_like(self._kc)
            self._pm = torch.zeros((rows, self.t_total), dtype=torch.bool, device=self.device)
        self._tok = np.zeros(rows, np.int64)
        self._pos = np.zeros(rows, np.int64)
        self._done = np.ones(rows, bool)
        self._ctx = np.zeros((rows, self.t_total), np.int64)
        self._vfrom = np.zeros(rows, np.int64)
        self._w = t_prompt                      # host-tracked write head
        self._slots: List[Optional[_Stream]] = [None] * rows
        self._pending: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self.joins = 0
        self.rejects = 0
        self.segments = 0
        self.spec_blocks = 0
        self.spec_tokens = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="continuous-decode")
        self._worker.start()
        log.info("continuous decode engine up: rows=%d t_prompt=%d window=%d "
                 "segment=%d spec_k=%d cache=%.0fMB on %s", rows, t_prompt, window,
                 segment, self.spec_k if self._spec_fn else 0,
                 2 * self._kc.numel() * self._kc.element_size() / 1e6, self.device)

    # ------------------------------------------------------------- public

    def submit(self, input_ids: np.ndarray, attention_mask: np.ndarray,
               max_new: int):
        """input_ids/attention_mask: [1, s] LEFT-padded (s <= t_prompt).
        Returns a token-block iterator, or None if not admissible."""
        s = int(input_ids.shape[1])
        cap = int(max_new)
        if s > self.t_prompt or cap > self.window or cap < 1:
            return None
        with self._lock:
            if self._closed:
                return None
            # admission: `cap` shared-window slots must remain (each row
            # needs only its own cap of headroom); rejecting beats queuing
            # behind an unbounded wait
            if not self._admissible(cap):
                self.rejects += 1
                return None
            stream = _Stream(cap)
            self._pending.put((input_ids, attention_mask, stream))
            self._wake.notify()
        return self._iter_blocks(stream)

    def stats(self) -> dict:
        return {"joins": self.joins, "rejects": self.rejects,
                "segments": self.segments, "spec_blocks": self.spec_blocks,
                "spec_tokens": self.spec_tokens}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._wake.notify()
        self._worker.join(timeout=30)

    # ------------------------------------------------------------ internals

    def _admissible(self, cap: int) -> bool:
        live = any(s is not None for s in self._slots)
        if not live and self._pending.empty():
            return True                          # head resets before the join
        return self._w + cap <= self.t_total

    def _iter_blocks(self, stream: _Stream):
        while True:
            item = stream.q.get()
            if item is None:
                return
            if item is _CLOSED:
                raise RuntimeError("continuous decode engine closed")
            if item is _REJECTED:
                # raced past the admission check before ANY token was
                # emitted; the typed error lets the caller fall back
                raise WindowRacedError("continuous decode window exhausted")
            yield item

    def _prefill_for(self, bucket: int):
        """The row prefill for a prompt bucket (one function for every
        bucket: eager torch, K9 on CUDA)."""
        return self._prefill

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                while True:
                    with self._lock:
                        while (not self._closed and self._pending.empty()
                               and all(s is None for s in self._slots)):
                            self._wake.wait()
                        if self._closed:
                            break
                    self._admit()   # per-request failures contained inside
                    if any(s is not None for s in self._slots):
                        # a failure HERE leaves the shared state half
                        # written: full shutdown is the only safe response
                        if self._spec_fn is not None and self._spec_admissible():
                            self._step_spec()
                        else:
                            self._step_segment()
        except Exception:  # noqa: BLE001 — a dead worker must not hang streams
            log.exception("continuous decode worker died")
            with self._lock:
                self._closed = True
        # drain: fail live + pending streams loudly, not silently
        for s in self._slots:
            if s is not None:
                s.q.put(_CLOSED)
        while not self._pending.empty():
            try:
                self._pending.get_nowait()[2].q.put(_CLOSED)
            except queue.Empty:
                break

    def _join(self, row: int, k_seq, v_seq, off: int, tok0: int, pos0: int,
              pm_row: np.ndarray, ids: np.ndarray, vfrom: int) -> None:
        """Install a prefilled request into slot ``row`` at cache [off,
        off+s). pm_row [T] (from the host, which knows the write head):
        prompt padding False, prompt tokens True, every slot from the write
        head on True, everything before the prompt False. The padded prompt
        goes into the row's fed-token history at the same slots, so prompt
        lookup can match against it; vfrom is its first real slot."""
        s = k_seq.shape[2]
        self._kc[:, row, off:off + s] = k_seq[:, 0]
        self._vc[:, row, off:off + s] = v_seq[:, 0]
        self._pm[row] = torch.from_numpy(pm_row).to(self.device)
        self._tok[row] = tok0
        self._pos[row] = pos0
        self._done[row] = tok0 == self.cfg.eos_token_id
        self._ctx[row, off:off + s] = ids[0]
        self._vfrom[row] = vfrom

    def _admit(self) -> None:
        """Join pending requests into free rows (prefill + cache copy)."""
        while not self._pending.empty():
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            with self._lock:
                if all(s is None for s in self._slots):
                    self._w = self.t_prompt      # empty engine: free reset
                try:
                    input_ids, mask, stream = self._pending.get_nowait()
                except queue.Empty:
                    return
                if self._w + stream.cap > self.t_total:
                    # window moved since submission's admission check
                    self.rejects += 1
                    stream.q.put(_REJECTED)
                    continue
                row, w = free[0], self._w
                self.joins += 1
            s = input_ids.shape[1]
            try:
                # prefill touches no shared state: a failure here fails ONLY
                # this stream; the worker and every live row keep going
                tok0, k_seq, v_seq = self._prefill_for(s)(input_ids, mask)
            except Exception:  # noqa: BLE001 — contain per-joiner failures
                log.exception("joiner prefill failed; failing one stream")
                stream.q.put(_CLOSED)
                continue
            off = w - s
            pm_row = np.zeros((self.t_total,), bool)
            pm_row[off: w] = np.asarray(mask[0]).astype(bool)
            pm_row[w:] = True
            n_real = int(np.asarray(mask).sum())
            self._join(row, k_seq, v_seq, off, tok0, n_real, pm_row,
                       np.asarray(input_ids), w - n_real)
            with self._lock:
                self._slots[row] = stream
            # tok0 is the request's first OUTPUT token (prefill's argmax),
            # exactly as generate_tokens emits it
            self._emit(row, np.asarray([tok0], np.int32))

    def _segment(self, w0: int):
        """`segment` greedy decode steps for every row; the tokens stay on
        the device until the end. Rows whose stream already finished keep
        feeding eos into their own row: junk only they attend to, and
        whose outputs the host discards. Returns [rows, segment] tokens."""
        eos = self.cfg.eos_token_id
        dev = self.device
        tok = torch.from_numpy(self._tok).to(dev)
        pos = torch.from_numpy(self._pos).to(dev)
        done = torch.from_numpy(self._done).to(dev)
        ys = []
        for i in range(self.segment):
            logits = _decode_one(self.params, tok, pos + i, w0 + i, self._kc, self._vc,
                                 self._pm, self.cfg)
            nxt = torch.where(done, eos, torch.argmax(logits, dim=-1))
            done = done | (nxt == eos)
            ys.append(nxt)
            tok = nxt
        toks = torch.stack(ys, dim=1).cpu().numpy()
        # fed tokens by slot, for later prompt lookups; each step's slot is
        # clamped into the buffer as JAX's dynamic_update_slice clamps it (a
        # segment that starts within `segment` of the end, after speculative
        # blocks moved the head off the segment grid, runs past it: the
        # cache writes there are empty slices, and no live row reads them)
        fed = np.concatenate([self._tok[:, None], toks[:, :-1]], axis=1)
        last = self._ctx.shape[1] - 1
        for i in range(self.segment):
            self._ctx[:, min(w0 + i, last)] = fed[:, i]
        self._done |= (toks == eos).any(axis=1)
        self._tok = toks[:, -1].copy()
        self._pos += self.segment
        return toks

    def _spec_block(self, w0: int):
        """ONE speculative block for every row: each row drafts spec_k
        tokens by n-gram match against its OWN fed history, one
        _verify_block_rows scores every row's block, and each row accepts
        its prefix-correct span (1..spec_k+1 tokens). The write head
        advances by the whole block; each row's rejected slots leave its
        prompt mask. Returns (emit [rows, blk], n_emit [rows])."""
        eos, k, blk = self.cfg.eos_token_id, self.spec_k, self.blk
        self._ctx[:, w0] = self._tok
        drafts = np.stack([_pl_drafts(self._ctx[r], w0, int(self._vfrom[r]),
                                      ngram=self.ngram, draft_k=k)
                           for r in range(self.rows)])
        block = np.concatenate([self._tok[:, None], drafts], axis=1)
        logits = _verify_block_rows(
            self.params, torch.from_numpy(block).to(self.device),
            torch.from_numpy(self._pos).to(self.device), w0, self._kc, self._vc,
            self._pm, self.cfg)
        preds = torch.argmax(logits, dim=-1).cpu().numpy()          # [rows, blk]
        acc = np.cumprod(drafts == preds[:, :k], axis=1).sum(axis=1)
        is_eos = preds == eos
        first_eos = np.where(is_eos.any(axis=1), np.argmax(is_eos, axis=1), blk)
        n_emit = np.minimum(acc + 1, first_eos + 1)
        n_emit = np.where(self._done, 1, n_emit)
        cols = np.arange(blk)[None, :]
        emit = np.where((cols < n_emit[:, None]) & ~self._done[:, None], preds, eos)
        # record fed/accepted tokens for future lookups; hide this block's
        # rejected slots from the row's future attention
        for r in range(self.rows):
            _update(self._ctx[r], emit[r], w0 + 1)
        self._pm[:, w0:w0 + blk] = torch.from_numpy(cols < n_emit[:, None]).to(self.device)
        rows = np.arange(self.rows)
        last = emit[rows, n_emit - 1]
        self._done = self._done | (last == eos) | is_eos[rows, n_emit - 1]
        self._tok = np.where(self._done, eos, last)
        self._pos = self._pos + n_emit
        return emit, n_emit

    def _spec_admissible(self) -> bool:
        """Spec blocks burn `blk` shared slots while emitting as few as one
        token per row; run one only when afterwards every live row could
        still FINISH on the greedy path (1 slot/step, rows share steps):
        w + blk + max(remaining) <= t_total."""
        with self._lock:
            rem = [s.cap - s.emitted for s in self._slots if s is not None]
        if not rem:
            return False
        return self._w + self.blk + max(rem) <= self.t_total

    def _step_spec(self) -> None:
        blocks, counts = self._spec_fn(self._w)
        with self._lock:
            self._w += self.blk
        self.spec_blocks += 1
        for row, stream in enumerate(self._slots):
            if stream is not None:
                self.spec_tokens += int(counts[row])
                self._emit(row, blocks[row, : counts[row]])

    def _step_segment(self) -> None:
        blocks = self._segment(self._w)
        with self._lock:
            self._w += self.segment
        self.segments += 1
        for row, stream in enumerate(self._slots):
            if stream is not None:
                self._emit(row, blocks[row])

    def _emit(self, row: int, toks: np.ndarray) -> None:
        """Push a row's new tokens to its stream; free the row at eos/cap."""
        stream = self._slots[row]
        keep = toks[: max(0, stream.cap - stream.emitted)]
        eos_hits = np.nonzero(keep == self.cfg.eos_token_id)[0]
        hit_eos = eos_hits.size > 0
        if hit_eos:
            keep = keep[: eos_hits[0]]           # trim AT eos (excluded)
        if keep.size:
            stream.q.put(keep[None, :].astype(np.int32))
            stream.emitted += int(keep.size)
        if hit_eos or stream.emitted >= stream.cap:
            stream.q.put(None)
            with self._lock:     # submit()'s admission check reads _slots
                self._slots[row] = None
