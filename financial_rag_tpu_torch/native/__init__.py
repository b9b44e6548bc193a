"""ctypes bindings for the native C++ components.

Counterpart of financial_rag_tpu/native: the same C++ sources (WordPiece,
BM25, the chunker's word scan), copied into this directory, and the same
Python API. The library is built at first use by calling the C++ compiler
directly (``$CXX``, else ``g++``, else ``c++``) with the JAX package's
Makefile flags, into ``build/native/libfragnative.so`` at the repository
root (``FRAG_NATIVE_BUILD_DIR`` overrides); it is rebuilt when a source is
newer than the library. Every binding has a pure-Python counterpart in the
module that uses it; ``available()`` reports whether the library loaded,
and without a compiler the Python paths serve and a warning is logged.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from financial_rag_tpu_torch.utils import get_logger

log = get_logger("native")

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("wordpiece.cc", "bm25.cc", "textutil.cc")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
LIB_NAME = "libfragnative.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_attempted = False
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("FRAG_NATIVE_BUILD_DIR")
    return Path(env) if env else SRC_DIR.parent.parent / "build" / "native"


def lib_path() -> Path:
    return build_dir() / LIB_NAME


def compiler() -> Optional[str]:
    env = os.environ.get("CXX")
    if env:
        return shutil.which(env) or env
    return shutil.which("g++") or shutil.which("c++")


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any((SRC_DIR / s).stat().st_mtime > built for s in SOURCES)


def build() -> Path:
    """Compile the sources into lib_path() unless it is newer than all of
    them. The library is written under a temporary name and renamed into
    place, so concurrent builders never load a half-written file."""
    lib = lib_path()
    if not _stale(lib):
        BUILD_INFO.setdefault("library", str(lib))
        return lib
    cxx = compiler()
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (set CXX, or install g++)")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libfragnative_", suffix=".so", dir=lib.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *(str(SRC_DIR / s) for s in SOURCES)],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO.update(compiler=cxx, seconds=time.perf_counter() - t0, library=str(lib))
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.wp_new.restype = ctypes.c_void_p
    lib.wp_new.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_tokenize.restype = ctypes.c_int32
    lib.wp_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.wp_tokenize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]

    lib.bm25_new.restype = ctypes.c_void_p
    lib.bm25_new.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.bm25_free.argtypes = [ctypes.c_void_p]
    lib.bm25_add_doc.restype = ctypes.c_int32
    lib.bm25_add_doc.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.bm25_finalize.argtypes = [ctypes.c_void_p]
    lib.bm25_num_docs.restype = ctypes.c_int32
    lib.bm25_num_docs.argtypes = [ctypes.c_void_p]
    lib.bm25_score.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_float)]

    lib.ft_word_count.restype = ctypes.c_int64
    lib.ft_word_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ft_word_starts.restype = ctypes.c_int64
    lib.ft_word_starts.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it first if needed; None (once warned)
    when it cannot be built."""
    global _lib, _attempted
    if _lib is not None or _attempted:
        return _lib
    with _lock:
        if _lib is not None or _attempted:
            return _lib
        _attempted = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or ""
            log.warning("native build unavailable (%s%s); using Python fallbacks", e,
                        f": {detail[-2000:]}" if detail else "")
            return None
        _bind(lib)
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def native_word_count(text_bytes: bytes) -> int:
    """\\w+ run count for ASCII bytes (exact re.findall(r"\\w+") count)."""
    lib = _load()
    return lib.ft_word_count(text_bytes, len(text_bytes))


def native_word_starts(text_bytes: bytes) -> np.ndarray:
    """Byte offsets of \\w+ run starts for ASCII bytes (int64 array)."""
    lib = _load()
    # words are separated by >=1 non-word byte, so at most ceil(len/2)+1
    cap = len(text_bytes) // 2 + 1
    out = np.empty(cap, np.int64)
    n = lib.ft_word_starts(text_bytes, len(text_bytes),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    return out[:n]


class NativeWordPiece:
    """C++ WordPiece for ASCII text (exact HF semantics for that subset).
    Use through tokenizer.wordpiece's wrapper, which routes non-ASCII to
    Python."""

    def __init__(self, vocab_tokens: Sequence[str]) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        data = "\n".join(vocab_tokens).encode("utf-8")
        self._handle = ctypes.c_void_p(lib.wp_new(data, len(data)))
        if not self._handle:
            raise RuntimeError("wp_new failed")

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.wp_free(self._handle)
        except Exception:
            pass

    def tokenize_ids(self, text: str, max_out: int = 4096) -> List[int]:
        raw = text.encode("ascii")
        out = (ctypes.c_int32 * max_out)()
        n = self._lib.wp_tokenize(self._handle, raw, len(raw), out, max_out)
        return list(out[:n])

    def tokenize_ids_batch_packed(self, texts: Sequence[str], max_out: int = 510):
        """One C++ call for the whole batch; returns the raw (ids [n,
        max_out] int32 zero-padded, lens [n] int32) matrices."""
        enc = [t.encode("ascii") for t in texts]
        offsets = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=offsets[1:])
        blob = b"".join(enc)
        n = len(enc)
        out = np.zeros((n, max_out), np.int32)
        lens = np.zeros(n, np.int32)
        self._lib.wp_tokenize_batch(
            self._handle, blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out, lens

    def tokenize_ids_batch(self, texts: Sequence[str], max_out: int = 510) -> List[List[int]]:
        out, lens = self.tokenize_ids_batch_packed(texts, max_out)
        return [out[i, : lens[i]].tolist() for i in range(len(texts))]


class NativeBM25:
    """C++ inverted-index BM25 with rank_bm25-compatible scoring."""

    def __init__(self, corpus_texts: Sequence[str],
                 k1: float = 1.5, b: float = 0.75, eps: float = 0.25) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.bm25_new(k1, b, eps))
        for t in corpus_texts:
            raw = t.encode("utf-8")
            lib.bm25_add_doc(self._handle, raw, len(raw))
        lib.bm25_finalize(self._handle)
        self.n_docs = lib.bm25_num_docs(self._handle)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.bm25_free(self._handle)
        except Exception:
            pass

    def get_scores(self, query_text: str) -> np.ndarray:
        out = np.zeros(self.n_docs, np.float32)
        raw = query_text.encode("utf-8")
        self._lib.bm25_score(self._handle, raw, len(raw),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
