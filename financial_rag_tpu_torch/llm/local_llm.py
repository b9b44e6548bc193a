"""On-device LLM provider: answer synthesis from a local HF checkpoint.

Counterpart of financial_rag_tpu/llm/local_llm.py. The reference can only
synthesize answers through an external HTTP API; this provider runs a
Qwen2/Llama-family checkpoint on the GPU itself (models/decoder.py), so the
whole RAG loop (retrieve, rerank, synthesize) works with no egress.

Point LLM_CHECKPOINT at a HuggingFace model directory (config.json +
model.safetensors, or sharded *.safetensors with their index, or
pytorch_model.bin; + tokenizer.json) and set LLM_PROVIDER=local. The
tokenizer.json is read by tokenizer/hf_json.py (WordLevel + Whitespace).
Prompts are LEFT-padded to length buckets and generation lengths are
bucketed, as in the JAX package, so both packages decode the same shapes.
Concurrent streams can join the shared continuous-batching decode
(``stream_via_engine``, llm/continuous.py), which serving/batcher.py's
``BatchingLLM`` routes to above its direct-lane limit.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from financial_rag_tpu_torch.config import LLMConfig
from financial_rag_tpu_torch.device import DeviceLike, resolve_device
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("llm.local")

# the full answer prompt (5 parents x 3000 chars, llm/prompts.py) runs
# ~4-5k tokens, so the top bucket must hold it: truncating to 2048 would
# silently drop the earliest retrieved context
_PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
_NEW_TOKEN_BUCKETS = (64, 256, 1024)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.bfloat16}


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _load_state_dict(model_dir: Path) -> dict:
    """model.safetensors, sharded *.safetensors via their index, or
    pytorch_model.bin -> {name: numpy array or tensor}."""
    from financial_rag_tpu_torch.models.checkpoint import read_safetensors

    single = model_dir / "model.safetensors"
    index = model_dir / "model.safetensors.index.json"
    if single.exists():
        return read_safetensors(single)
    if index.exists():
        sd: dict = {}
        for name in sorted(set(json.loads(index.read_text())["weight_map"].values())):
            sd.update(read_safetensors(model_dir / name))
        return sd
    return torch.load(str(model_dir / "pytorch_model.bin"), map_location="cpu",
                      weights_only=True)


class LocalLLM:
    """LLMProvider backed by models/decoder.py. Thread-safe; loads lazily,
    onto ``device`` (the argument, else FRAG_PLATFORM, else cuda)."""

    name = "local"

    def __init__(self, cfg: Optional[LLMConfig] = None, model_dir: Optional[str] = None,
                 dtype: Optional[str] = None, max_prompt_tokens: int = 4096,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg or LLMConfig()
        self.model_dir = Path(model_dir or self.cfg.local_checkpoint or "")
        # "bfloat16" (default) | "int8" (weight-only, bf16 activations) | "float32"
        self.dtype = dtype or self.cfg.local_dtype
        self.max_prompt_tokens = max_prompt_tokens
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._loaded = False
        self._failed = False
        self._params = None
        self._dcfg = None
        self._tok = None
        self._chat: Optional[str] = None     # "chatml" | "inst" | None
        self._engine = None                  # lazy ContinuousDecodeEngine

    # ----------------------------------------------------------------- load

    def _ensure_loaded(self) -> bool:
        if self._loaded:
            return True
        if self._failed:
            return False
        with self._lock:
            if self._loaded or self._failed:
                return self._loaded
            try:
                self._load()
                self._loaded = True
            except Exception as e:  # noqa: BLE001 — degrade, don't crash serving
                log.warning("local LLM unavailable (%s): %s", self.model_dir, e)
                self._failed = True
        return self._loaded

    def _load(self) -> None:
        from financial_rag_tpu_torch.models.decoder import (
            DecoderConfig, decoder_params_from_torch_state_dict, fuse_decoder_params,
            quantize_decoder_params)
        from financial_rag_tpu_torch.tokenizer.hf_json import HFTokenizer

        if self.dtype not in _DTYPES:
            raise ValueError(f"LLM_DTYPE {self.dtype!r}: expected one of {sorted(_DTYPES)}")
        hf_cfg = json.loads((self.model_dir / "config.json").read_text())
        self._dcfg = DecoderConfig.from_hf_config(hf_cfg)
        sd = _load_state_dict(self.model_dir)
        self._params = decoder_params_from_torch_state_dict(
            sd, self._dcfg, dtype=_DTYPES[self.dtype], device=self.device)
        del sd
        if self.dtype == "int8":   # weight-only quant: half the decode weight bytes
            self._params = quantize_decoder_params(self._params)
        # single-device serving: q/k/v and gate/up as one matmul each (exact)
        self._params = fuse_decoder_params(self._params)
        self._tok = HFTokenizer.from_file(self.model_dir / "tokenizer.json")

        # chat-template detection: enough to cover the two template families
        # these architectures ship with; anything else runs as completion
        tcfg_path = self.model_dir / "tokenizer_config.json"
        template = ""
        if tcfg_path.exists():
            template = json.loads(tcfg_path.read_text()).get("chat_template") or ""
        if "im_start" in template:
            self._chat = "chatml"
        elif "[INST]" in template:
            self._chat = "inst"
        log.info("local LLM loaded: %s (%d layers, %d hidden, %s on %s, template=%s)",
                 self.model_dir.name, self._dcfg.num_layers, self._dcfg.hidden_size,
                 self.dtype, self.device, self._chat or "completion")

    # ------------------------------------------------------------- provider

    def available(self) -> bool:
        return self._ensure_loaded()

    def _wrap(self, prompt: str) -> str:
        if self._chat == "chatml":
            return (f"<|im_start|>user\n{prompt}<|im_end|>\n"
                    f"<|im_start|>assistant\n")
        if self._chat == "inst":
            return f"[INST] {prompt} [/INST]"
        return prompt

    def _prep(self, prompt: str):
        """Tokenize + LEFT-pad to a bucket -> (ids, mask) int32 arrays [1, bucket]."""
        ids = self._tok.encode(self._wrap(prompt)).ids[-self.max_prompt_tokens:]
        bucket = _bucket(len(ids), _PROMPT_BUCKETS)
        pad = bucket - len(ids)
        input_ids = np.full((1, bucket), self._dcfg.eos_token_id, np.int32)
        mask = np.zeros((1, bucket), np.int32)
        input_ids[0, pad:] = ids                    # LEFT padding
        mask[0, pad:] = 1
        return input_ids, mask

    @staticmethod
    def _clean(text: str) -> str:
        # a chat turn ends at the template's end marker even if the model
        # keeps going (no eos in the first max_new tokens)
        for stop in ("<|im_end|>", "</s>", "[INST]"):
            if stop in text:
                text = text.split(stop, 1)[0]
        return text

    def _trim(self, row) -> str:
        """Token ids -> text, cut at the first eos."""
        row = list(row)
        if self._dcfg.eos_token_id in row:
            row = row[:row.index(self._dcfg.eos_token_id)]
        return self._clean(self._tok.decode(row, skip_special_tokens=True)).strip()

    def warm(self) -> bool:
        """Run the serving answer programs once at the shapes real requests
        hit: the segmented stream (prefill + first segment, then one
        steady-state segment) and the one-shot generate, on a synthetic
        5-parent answer prompt (the 4,096 bucket serving prompts land in).
        Returns True when the provider is live."""
        if not self._ensure_loaded():
            return False
        from financial_rag_tpu_torch.llm.prompts import build_answer_prompt
        filler = ("amount due rent invoice total period lease tax schedule " * 60)[:3000]
        prompt = build_answer_prompt(
            "what is the total amount due for the period?",
            [{"content": filler, "title": f"warm {i}"} for i in range(5)])
        gen = self.generate_stream(prompt)
        next(gen, None)
        next(gen, None)
        gen.close()
        self.generate(prompt)   # default caps == serving caps: same bucket
        return True

    def _max_new(self, max_tokens: int):
        max_tokens = min(max_tokens, self.cfg.local_max_new_tokens)
        return max_tokens, _bucket(max(1, max_tokens), _NEW_TOKEN_BUCKETS)

    def generate(self, prompt: str, *, max_tokens: int = 1024) -> Optional[str]:
        if not self._ensure_loaded():
            return None
        from financial_rag_tpu_torch.models.decoder import generate_tokens, generate_tokens_spec

        input_ids, mask = self._prep(prompt)
        max_tokens, max_new = self._max_new(max_tokens)
        spec_k = max(0, int(self.cfg.local_spec_k))
        if spec_k:
            # batch-1 greedy: prompt-lookup speculation emits greedy-
            # equivalent tokens in fewer weight-stream-bound steps
            toks, _steps = generate_tokens_spec(self._params, input_ids, mask, cfg=self._dcfg,
                                                max_new_tokens=max_new, draft_k=spec_k)
        else:
            toks = generate_tokens(self._params, input_ids, mask, cfg=self._dcfg,
                                   max_new_tokens=max_new, temperature=0.0)
        # the device generates a full bucket; the CONTRACT is max_tokens
        return self._trim(toks[0].tolist()[:max_tokens]) or None

    def generate_many(self, prompts, *, max_tokens=1024):
        """Batched generation: one decode answers every prompt. Prompts
        LEFT-pad to the largest bucket in the wave; the batch pads to a
        power of two. ``max_tokens`` is one int or one cap per prompt: the
        decode runs to the largest cap's bucket and each row is trimmed to
        its own cap. Returns one Optional[str] per prompt, in order."""
        if not prompts:
            return []
        if not self._ensure_loaded():
            return [None] * len(prompts)
        from financial_rag_tpu_torch.models.decoder import generate_tokens

        if isinstance(max_tokens, (list, tuple)):
            if len(max_tokens) != len(prompts):
                raise ValueError(f"{len(max_tokens)} caps for {len(prompts)} prompts")
            caps = [max(1, min(int(m), self.cfg.local_max_new_tokens)) for m in max_tokens]
        else:
            caps = [max(1, min(int(max_tokens), self.cfg.local_max_new_tokens))] * len(prompts)
        max_new = _bucket(max(caps), _NEW_TOKEN_BUCKETS)
        rows = [self._prep(p) for p in prompts]
        bucket = max(r[0].shape[1] for r in rows)
        b = _bucket(len(rows), (1, 2, 4, 8, 16, 32))
        input_ids = np.full((b, bucket), self._dcfg.eos_token_id, np.int32)
        mask = np.zeros((b, bucket), np.int32)
        for i, (ids, m) in enumerate(rows):
            w = ids.shape[1]
            input_ids[i, bucket - w:] = ids[0]    # re-left-pad to the wave
            mask[i, bucket - w:] = m[0]           # bucket (pads stay masked)
        toks = generate_tokens(self._params, input_ids, mask, cfg=self._dcfg,
                               max_new_tokens=max_new, temperature=0.0).cpu()
        return [self._trim(toks[i].tolist()[:caps[i]]) or None for i in range(len(rows))]

    def generate_stream(self, prompt: str, *, max_tokens: int = 1024, segment: int = 48):
        """Yield text deltas. The tokens are generate()'s; each segment is
        one block of decode steps, so the first words appear after prefill
        and one segment instead of the whole generation."""
        if not self._ensure_loaded():
            return
        from financial_rag_tpu_torch.models.decoder import generate_stream, generate_stream_spec

        input_ids, mask = self._prep(prompt)
        max_tokens, max_new = self._max_new(max_tokens)
        spec_k = max(0, int(self.cfg.local_spec_k))
        if spec_k:
            stream = generate_stream_spec(self._params, input_ids, mask, cfg=self._dcfg,
                                          max_new_tokens=max_new, segment=segment,
                                          draft_k=spec_k)
        else:
            stream = generate_stream(self._params, input_ids, mask, cfg=self._dcfg,
                                     max_new_tokens=max_new, segment=segment, temperature=0.0)
        yield from self._blocks_to_deltas(stream, max_tokens)

    def _blocks_to_deltas(self, stream, max_tokens: int):
        """Token blocks [1, n] -> text deltas (shared by the per-request
        stream and the continuous engine path)."""
        toks: list = []
        emitted = ""
        for block in stream:
            # bucket -> requested cap: emit at most max_tokens in total
            row = block[0].tolist()[:max(0, max_tokens - len(toks))]
            stop = self._dcfg.eos_token_id in row
            if stop:
                row = row[:row.index(self._dcfg.eos_token_id)]
            toks.extend(row)
            # re-decode the full prefix: merges can span block borders
            raw = self._tok.decode(toks, skip_special_tokens=True)
            text = self._clean(raw)
            done = stop or len(toks) >= max_tokens or text != raw
            # hold back a trailing U+FFFD: a multi-byte character split across
            # a segment border decodes to it until the next block completes
            # it, and the deltas must stay a prefix of the final text
            stable = text if done else text.rstrip("�")
            if stable.startswith(emitted):
                if len(stable) > len(emitted):
                    yield stable[len(emitted):]
                    emitted = stable
            elif done:
                # already-sent deltas cannot be retracted: fail the stream so
                # the caller's degradation path regenerates a consistent answer
                raise RuntimeError("stream decode diverged from emitted prefix")
            if done:
                return   # eos, cap reached, or a stop marker ended the turn

    # ------------------------------------------------- continuous batching

    def _get_engine(self):
        """Lazy shared ContinuousDecodeEngine (llm/continuous.py)."""
        with self._lock:
            if self._engine is None:
                from financial_rag_tpu_torch.llm.continuous import ContinuousDecodeEngine

                self._engine = ContinuousDecodeEngine(
                    self._params, self._dcfg,
                    rows=max(1, int(self.cfg.local_continuous_rows)),
                    t_prompt=_bucket(self.max_prompt_tokens, _PROMPT_BUCKETS),
                    window=max(64, int(self.cfg.local_continuous_window)),
                    spec_k=max(0, int(getattr(self.cfg, "local_continuous_spec_k", 0))))
            return self._engine

    def stream_via_engine(self, prompt: str, *, max_tokens: int = 1024):
        """Join the shared continuous-batching decode; yield text deltas.

        Returns None when the engine is disabled or cannot admit the
        request (window exhausted): the caller falls back to the
        per-request ``generate_stream``, so routing here never loses a
        request. The tokens are the same greedy sequence as
        ``generate_stream``'s (exactly so in f32; see llm/continuous.py on
        bf16 near-ties)."""
        if int(self.cfg.local_continuous_rows) <= 0 or not self._ensure_loaded():
            return None
        input_ids, mask = self._prep(prompt)
        max_tokens = min(max_tokens, self.cfg.local_max_new_tokens)
        it = self._get_engine().submit(input_ids, mask, max(1, max_tokens))
        if it is None:
            return None
        return self._blocks_to_deltas(it, max_tokens)
