"""Shared index-persistence helpers.

Counterpart of financial_rag_tpu/index/persist.py, with the same npz layout,
manifest and dtype names, so an index saved by either package loads in the
other.

- Atomic writes: npz + manifest go to a temp file in the same directory and
  are os.replace()d into place, so a crash mid-save or a concurrent
  cross-process loader never observes a truncated file.
- dtype registry: manifests record the storage dtype by name so a reload
  reconstructs the index faithfully (an int8 index saved as raw ±127
  quantized values must not be reinterpreted as bf16 unit vectors).
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np
import torch

from financial_rag_tpu_torch.ops.topk import INT8_SCALE

STR_TO_DTYPE = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
}


def dtype_name(dtype) -> str:
    """Storage dtype name as the manifests spell it ("bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def atomic_savez(path: Path, **arrays) -> None:
    """np.savez_compressed with tmp-file + rename (np appends .npz itself,
    so the tmp name must end in .npz). The tmp name is UNIQUE per call:
    concurrent savers of the same checkpoint (/admin/save racing the
    post-sweep persistence) must not interleave writes into one tmp file —
    last rename wins, each rename publishing a complete archive."""
    path = Path(path)
    tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}_{threading.get_ident()}.npz")
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        # unique tmp names don't self-heal by overwrite: a failed write
        # (e.g. ENOSPC, retried every sweep) must not leak a file per
        # attempt
        tmp.unlink(missing_ok=True)
        raise


def atomic_write_text(path: Path, text: str) -> None:
    path = Path(path)
    # unique tmp per writer (same rationale + cleanup as atomic_savez)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}_{threading.get_ident()}")
    try:
        tmp.write_text(text)
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def atomic_write_json(path: Path, obj) -> None:
    atomic_write_text(path, json.dumps(obj, indent=2))


def encode_payload(vectors_f32: np.ndarray, dtype, device="cpu"):
    """Host float32 unit vectors -> (device payload, per-row weights f32).

    int8 quantizes PER VECTOR by its max-abs coordinate; the weight
    (max/127) rides in the index's validity array and the search multiplies
    scores by it, so live slots carry their dequantization scale and empty
    slots stay 0. Float dtypes get weight 1.0 (scores pass through)."""
    v = np.asarray(vectors_f32, np.float32)
    if dtype == torch.int8:
        m = np.maximum(np.abs(v).max(axis=1), 1e-12)
        q = np.clip(np.round(v * (INT8_SCALE / m[:, None])), -127, 127).astype(np.int8)
        return torch.from_numpy(q).to(device), (m / INT8_SCALE).astype(np.float32)
    return torch.from_numpy(v).to(device=device, dtype=dtype), np.ones(v.shape[0], np.float32)


def decode_payload(raw: np.ndarray, saved_dtype: str | None,
                   weights: np.ndarray | None = None) -> np.ndarray:
    """Saved npz payload -> float32 unit-vector space. int8 indexes persist
    their raw quantized values (cast to f32 in the npz) with per-row
    dequantization weights in the validity array; everything else is
    already in unit-vector space. Weights > 0.5 mean legacy validity flags
    (a real weight is <= 1/127): fall back to the global 1/127 decode."""
    raw = np.asarray(raw, np.float32)
    if saved_dtype == "int8":
        if weights is not None and len(weights) and np.max(weights) <= 0.5:
            return raw * np.asarray(weights, np.float32)[:, None]
        return raw / INT8_SCALE
    return raw
