"""Batched sentence-encoder service.

Counterpart of financial_rag_tpu/models/encoder.py: texts are tokenized
host-side (exact WordPiece), bucketed by sequence length to {64, 128, 256,
512} and padded to a fixed batch (8 / 32 for small query batches, the
ingest batch otherwise); each batch is one encoder forward + pooling on the
device. There is no ``jit``: PyTorch launches eagerly, and a CUDA launch
returns before the device finishes, so the begin/materialize split still
overlaps host work with device work.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from financial_rag_tpu_torch.config import ModelConfig
from financial_rag_tpu_torch.device import resolve_device
from financial_rag_tpu_torch.models.bert import bert_encode, bert_forward, prepare_params
from financial_rag_tpu_torch.models.checkpoint import load_params
from financial_rag_tpu_torch.tokenizer import WordPieceTokenizer
from financial_rag_tpu_torch.utils import get_logger, time_block

log = get_logger("models.encoder")

SEQ_BUCKETS = (64, 128, 256, 512)


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the GPU (the kernels' type), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


class Encoder:
    """One checkpoint, batched encode to unit vectors."""

    device_backed = True
    # class flags, not hasattr: wrappers that delegate attribute lookups
    # opt in/out explicitly (same contract as the JAX package)
    supports_encode_begin = True
    accepts_seqs = True         # encode_begin(seqs=...) pretokenized input
    supports_device_out = True  # encode_begin_device exists

    def __init__(
        self,
        config: ModelConfig,
        params,
        tokenizer: Optional[WordPieceTokenizer] = None,
        *,
        pooling: str = "mean",
        batch_size: int = 128,
        max_seq_len: int = 512,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        replicas: Optional[Sequence] = None,
    ) -> None:
        """``replicas``: one device per data-parallel replica (None or one
        device: single-device encode); the first is the encoder's device."""
        self.config = config
        self.replicas = [torch.device(d) for d in replicas] if replicas else None
        self.device = self.replicas[0] if self.replicas else resolve_device(device)
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        # one prepared copy of the weights per distinct device
        self._params_on: Dict[torch.device, object] = {}
        for dev in self.replicas or [self.device]:
            if dev not in self._params_on:
                self._params_on[dev] = prepare_params(params, device=dev,
                                                      compute_dtype=self.compute_dtype)
        self.params = self._params_on[self.device]
        self.tokenizer = tokenizer or WordPieceTokenizer()
        self.pooling = pooling
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        # every batch bucket must split evenly over the replicas: batch_size
        # rounds up to a multiple, and _batch_bucket floors at their count
        self.n_replicas = len(self.replicas) if self.replicas else 1
        if self.batch_size % self.n_replicas:
            self.batch_size = (self.batch_size // self.n_replicas + 1) * self.n_replicas

    @classmethod
    def from_pretrained(cls, model_dir: str, *, pooling: str, fallback_seed: Optional[int] = None,
                        **kwargs) -> "Encoder":
        params, config = load_params(model_dir, fallback_seed=fallback_seed)
        tok = WordPieceTokenizer(vocab_path=os.path.join(model_dir, "vocab.txt")
                                 if os.path.exists(os.path.join(model_dir, "vocab.txt")) else None)
        return cls(config, params, tok, pooling=pooling, **kwargs)

    @property
    def dim(self) -> int:
        return self.config.hidden_size

    def _forward_on(self, dev: torch.device, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        return bert_encode(
            self._params_on[dev],
            torch.from_numpy(ids).to(dev),
            torch.from_numpy(mask).to(dev),
            config=self.config, pooling=self.pooling, compute_dtype=self.compute_dtype)

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        if self.replicas is None:
            return self._forward_on(self.device, ids, mask)
        # one equal row share per replica, every forward launched before
        # any is gathered onto the first replica's device
        share = ids.shape[0] // self.n_replicas
        outs = [self._forward_on(dev, ids[r * share:(r + 1) * share],
                                 mask[r * share:(r + 1) * share])
                for r, dev in enumerate(self.replicas)]
        return torch.cat([o.to(self.device) for o in outs])

    def _bucket(self, n_tokens: int) -> int:
        for b in SEQ_BUCKETS:
            if n_tokens <= b and b <= self.max_seq_len:
                return b
        return self.max_seq_len

    def _batch_bucket(self, n: int) -> int:
        """Pad tiny (query-time) batches to 8/32 instead of the full ingest
        batch — a 3-variant query encode shouldn't pay for 128 rows. With
        replicas every bucket must split evenly over them, so their count
        floors the bucket."""
        floor = self.n_replicas
        for b in (8, 32):
            if n <= b and b < self.batch_size and b % floor == 0:
                return b
        return max(self.batch_size, floor)

    def encode_begin(self, texts: Sequence[str], *, seqs=None):
        """Tokenize and launch every device batch; returns a zero-arg
        materializer producing [N, dim] float32 unit vectors (input order).
        ``seqs``: precomputed packed (ids, lens) from this tokenizer's
        encode_many_packed (an ensemble sharing one vocab tokenizes once)."""
        pending = self._dispatch_batches(texts, seqs)
        if pending is None:
            return lambda: np.zeros((0, self.dim), np.float32)

        def materialize() -> np.ndarray:
            out = np.zeros((len(texts), self.dim), np.float32)
            for batch_idx, n, emb in pending:
                out[batch_idx] = emb[:n].float().cpu().numpy()
            return out

        return materialize

    def encode_begin_device(self, texts: Sequence[str], *, seqs=None,
                            seq_bucket: Optional[int] = None,
                            rows_bucket: Optional[int] = None):
        """Like encode_begin but the materializer returns a DEVICE [N, dim]
        tensor in input order (an on-device gather; nothing crosses to the
        host). Feeds device-direct index upserts and chained sweeps.
        ``seq_bucket`` / ``rows_bucket`` pin every row to one sequence bucket
        and the call to one batch shape."""
        pending = self._dispatch_batches(texts, seqs, seq_bucket=seq_bucket,
                                         rows_bucket=rows_bucket)
        if pending is None:
            return lambda: torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)

        def materialize_device():
            if len(pending) == 1:
                batch_idx, n, emb = pending[0]
                embs, order = emb[:n], batch_idx
            else:
                embs = torch.cat([emb[:n] for _, n, emb in pending])
                order = np.concatenate([bi for bi, _, _ in pending])
            inv = np.empty(len(order), np.int64)
            inv[order] = np.arange(len(order), dtype=np.int64)
            return embs[torch.from_numpy(inv).to(self.device)]

        return materialize_device

    def _dispatch_batches(self, texts: Sequence[str], seqs=None, *,
                          seq_bucket: Optional[int] = None,
                          rows_bucket: Optional[int] = None):
        """Tokenize + launch every device forward; returns a list of
        (batch_idx, n_valid, device_emb) or None for an empty input."""
        if not len(texts):
            return None
        if seqs is None:
            with time_block("encoder.tokenize"):
                seqs = self.tokenizer.encode_many_packed(texts, max_len=self.max_seq_len)
        all_ids, all_lens = seqs

        order = np.argsort(all_lens, kind="stable")
        if seq_bucket is not None:
            pin = min(int(seq_bucket), self.max_seq_len)
            bucket_of = np.full(len(texts), pin)
        else:
            bucket_of = np.asarray([self._bucket(int(ln)) for ln in all_lens])
        pending = []
        lo = 0
        n_total = len(texts)
        while lo < n_total:
            seq_len = int(bucket_of[order[lo]])
            hi = lo
            while hi < n_total and bucket_of[order[hi]] == seq_len and hi - lo < self.batch_size:
                hi += 1
            batch_idx = order[lo:hi]
            lo = hi
            n = len(batch_idx)
            # a pinned row count must still split evenly over the replicas
            pin_ok = (rows_bucket is not None and rows_bucket >= n
                      and rows_bucket % self.n_replicas == 0)
            bsz = rows_bucket if pin_ok else self._batch_bucket(n)
            ids = np.full((bsz, seq_len), self.tokenizer.pad_id, np.int32)
            mask = np.zeros((bsz, seq_len), np.int32)
            ids[:n] = all_ids[batch_idx, :seq_len]
            mask[:n] = np.arange(seq_len)[None, :] < np.minimum(
                all_lens[batch_idx], seq_len)[:, None]
            # pad rows must be non-empty for the masked ops; mark 1 token
            mask[n:, 0] = 1
            with time_block(f"encoder.forward_s{seq_len}"):
                emb = self._forward(ids, mask)
            pending.append((batch_idx, n, emb))
        return pending

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Encode texts -> [N, dim] float32 unit vectors (input order)."""
        return self.encode_begin(texts)()

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]


class TokenEncoder:
    """Per-token embeddings for the late-interaction (multivector) tier:
    encoder last hidden states with CLS/SEP dropped, L2-normalized
    (semantics of reference multivector_store.py:100-110). Runs
    ``bert_forward`` on the encoder's own weights (``encoder.params``), on
    its device and in its compute dtype, so on CUDA every forward launches
    K2 and K3 (the JAX package picks XLA attention here; the port has no
    such cut-off, see models/bert.py)."""

    def __init__(self, encoder: Encoder, max_tokens: int = 128,
                 batch_size: int = 32) -> None:
        self.encoder = encoder
        self.max_tokens = max_tokens
        self.batch_size = batch_size

    def _hidden(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        enc = self.encoder
        hidden = bert_forward(enc.params, torch.from_numpy(ids).to(enc.device),
                              torch.from_numpy(mask).to(enc.device), config=enc.config,
                              compute_dtype=enc.compute_dtype)
        return hidden.float().cpu().numpy()

    def encode_tokens(self, texts: Sequence[str]) -> List[np.ndarray]:
        """Per-text ragged token embeddings, computed in length-bucketed
        batched forwards (one forward per bucket chunk)."""
        enc = self.encoder
        if not len(texts):
            return []
        seqs = [enc.tokenizer.encode(t, max_len=self.max_tokens + 2) for t in texts]
        buckets: Dict[int, List[int]] = {}
        for i, s in enumerate(seqs):
            pad_to = min(max(64, ((len(s) + 63) // 64) * 64), enc.max_seq_len)
            buckets.setdefault(pad_to, []).append(i)

        out: List[Optional[np.ndarray]] = [None] * len(texts)
        pad_id = enc.tokenizer.pad_id
        for seq_len, idxs in sorted(buckets.items()):
            for lo in range(0, len(idxs), self.batch_size):
                batch_idx = idxs[lo: lo + self.batch_size]
                n = len(batch_idx)
                bsz = 8 if n <= 8 else self.batch_size
                ids = np.full((bsz, seq_len), pad_id, np.int32)
                mask = np.zeros((bsz, seq_len), np.int32)
                for r, i in enumerate(batch_idx):
                    s = seqs[i][:seq_len]
                    ids[r, : len(s)] = s
                    mask[r, : len(s)] = 1
                mask[n:, 0] = 1  # pad rows must be non-empty for masked ops
                hidden = self._hidden(ids, mask)
                for r, i in enumerate(batch_idx):
                    ln = len(seqs[i])
                    vecs = hidden[r, 1: ln - 1]  # drop CLS/SEP
                    if len(vecs) == 0:
                        vecs = hidden[r, :1]
                    out[i] = vecs / np.maximum(
                        np.linalg.norm(vecs, axis=1, keepdims=True), 1e-12)
        return out


class DualEncoder:
    """The BAAI + GTE ensemble (reference retriever.py:26-57): two encoders
    sharing one tokenizer/vocab, each feeding its own index collection, plus
    the dormant fused single-vector mode (0.6/0.4 — reference
    chunker.py:252-260)."""

    def __init__(self, encoders: Dict[str, Encoder], fused_weights: Tuple[float, ...] = (0.6, 0.4),
                 cache=None):
        assert encoders, "at least one encoder required"
        self.encoders = encoders
        self.fused_weights = fused_weights
        self.cache = cache  # optional utils.embed_cache.EmbeddingCache (query side)
        self._shared_tok = None  # lazily resolved; False = not shareable

    @property
    def names(self) -> List[str]:
        return list(self.encoders.keys())

    def _shared_tokenizer(self):
        """The one tokenizer all member encoders agree on, or None. BAAI
        bge-small and GTE-small ship byte-identical bert-uncased vocabs, so
        the ensemble tokenizes each text ONCE."""
        if self._shared_tok is None:
            toks = []
            for enc in self.encoders.values():
                if not getattr(type(enc), "accepts_seqs", False):
                    toks = None
                    break
                toks.append((enc.tokenizer, enc.max_seq_len))
            ok = bool(toks) and all(
                s == toks[0][1] and (t is toks[0][0] or t.vocab == toks[0][0].vocab)
                for t, s in toks)
            self._shared_tok = toks[0] if ok else False
        return self._shared_tok or None

    def encode_all_begin(self, texts: Sequence[str], *,
                         device_out: bool = False) -> Dict[str, object]:
        """Begin every encoder (tokenizing once when vocabs agree) WITHOUT
        materializing: {model_name: materializer-or-array}. device_out:
        materializers yield device tensors (for device-direct index upserts);
        encoders without the begin-split still return host arrays."""
        seqs = None
        shared = self._shared_tokenizer()
        if shared is not None and len(texts):
            tok, max_len = shared
            with time_block("encoder.tokenize"):
                seqs = tok.encode_many_packed(texts, max_len=max_len)
        out: Dict[str, object] = {}
        for name, enc in self.encoders.items():
            t = type(enc)
            if device_out and getattr(t, "supports_device_out", False):
                out[name] = enc.encode_begin_device(texts, seqs=seqs)
            elif getattr(t, "supports_encode_begin", False):
                out[name] = (enc.encode_begin(texts, seqs=seqs)
                             if getattr(t, "accepts_seqs", False)
                             else enc.encode_begin(texts))
            else:
                out[name] = enc.encode(texts)
        return out

    def cached_all(self, texts: Sequence[str]) -> Optional[Dict[str, np.ndarray]]:
        """Every (model, text) embedding straight from the query cache, or
        None if ANY is missing (all-or-nothing, as in the JAX package)."""
        if self.cache is None or not len(texts):
            return None
        out: Dict[str, np.ndarray] = {}
        for name in self.encoders:
            vecs = [self.cache.get(name, t) for t in texts]
            if any(v is None for v in vecs):
                return None
            out[name] = np.stack(vecs)
        return out

    def encode_all(self, texts: Sequence[str], use_cache: bool = False) -> Dict[str, np.ndarray]:
        """Per-model embeddings: {model_name: [N, D]}. use_cache routes
        through the md5 embedding cache (query side only)."""
        if not (use_cache and self.cache is not None):
            begun = self.encode_all_begin(texts)
            return {name: (v() if callable(v) else v) for name, v in begun.items()}
        vecs_by: Dict[str, list] = {}
        missing_by: Dict[str, list] = {}
        begun2: Dict[str, object] = {}
        for name, enc in self.encoders.items():
            vecs = [self.cache.get(name, t) for t in texts]
            missing = [i for i, v in enumerate(vecs) if v is None]
            vecs_by[name] = vecs
            missing_by[name] = missing
            if missing:
                miss_texts = [texts[i] for i in missing]
                begun2[name] = (enc.encode_begin(miss_texts)
                                if getattr(type(enc), "supports_encode_begin", False)
                                else enc.encode(miss_texts))
        out: Dict[str, np.ndarray] = {}
        for name in self.encoders:
            vecs, missing = vecs_by[name], missing_by[name]
            if missing:
                v = begun2[name]
                fresh = v() if callable(v) else v
                for row, i in enumerate(missing):
                    vecs[i] = fresh[row]
                    self.cache.put(name, texts[i], fresh[row])
            out[name] = np.stack(vecs)
        return out

    def encode_fused(self, texts: Sequence[str]) -> np.ndarray:
        """Weighted-sum single vector, re-normalized."""
        per = self.encode_all(texts)
        acc = None
        for w, name in zip(self.fused_weights, self.names):
            acc = w * per[name] if acc is None else acc + w * per[name]
        return acc / np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
