"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and one more ``nvcc`` links the objects
into a single shared library with a plain C interface, loaded with
``ctypes``. The library's file name carries a hash of the sources and flags,
so an edited source is never served by a stale build. It is built at first
use into ``build/kernels/`` at the repository root (``FRAG_KERNEL_BUILD_DIR``
overrides), and the compiler's output, ``-Xptxas -v`` register and
shared-memory counts included, is kept beside it as ``build_<hash>.log``.

Nothing here runs at import time: the CPU tests import every wrapper module,
and only a CUDA tensor makes a wrapper call :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "frag_pool_norm": [_P, _P, _P, _I, _I, _I, _I, _P],
    "frag_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "frag_flash_attention_bwd": [_P] * 9 + [_I] * 5 + [_P],
    "frag_fused_ffn": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "frag_fused_ffn_large": [_P] * 8 + [_I] * 6 + [_P],
    "frag_packed_topk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "frag_bucketed_topk": [_P] * 6 + [_I] * 8 + [_P],
    "frag_topk_exact": [_P] * 6 + [_I] * 9 + [_P],
    "frag_probe_scores": [_P] * 5 + [_I] * 6 + [_P],
    "frag_causal_flash": [_P] * 5 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib = None
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("FRAG_KERNEL_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "kernels"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from csrc/ at first use on the GPU machine")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library if it is not built yet;
    returns its path. Raises with the compiler's output on failure."""
    digest = _digest()
    out_dir = build_dir()
    lib_path = out_dir / f"libfrag_kernels_{digest}.so"
    if lib_path.exists():
        BUILD_INFO.setdefault("library", str(lib_path))
        BUILD_INFO.setdefault("seconds", 0.0)
        if (out_dir / f"build_{digest}.log").exists():
            BUILD_INFO.setdefault("log", str(out_dir / f"build_{digest}.log"))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="build_", dir=out_dir))
    try:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode:
                failed.append(src.name)
        log_path = out_dir / f"build_{digest}.log"
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / "lib.so"),
                 *[str(obj) for _, obj, _ in jobs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode:
                failed.append("link")
        log_path.write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):\n"
                               + "\n".join(logs))
        os.replace(tmp / "lib.so", lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(library=str(lib_path), log=str(log_path),
                      seconds=time.perf_counter() - t0)
    return lib_path


def load():
    """The loaded library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.frag_error_string.argtypes = [ctypes.c_int]
            lib.frag_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all tensors lie on; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel inputs must share one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
    return dev


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a kernel that has no backward: its
    output would carry no gradient, and the graph would be cut silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and an input needs a "
                           f"gradient; call it under torch.no_grad() or on detached tensors")


def require_contiguous(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels'
    vector and cp.async loads)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must start on a 16-byte boundary")


def dtype_code(name: str, dtype: torch.dtype, allowed=(torch.float32, torch.bfloat16)) -> int:
    if dtype not in allowed:
        raise TypeError(f"{name}: dtype {dtype} not supported by the kernel "
                        f"(takes {', '.join(str(a) for a in allowed)})")
    return DTYPE_CODES[dtype]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream and raise if
    the launch was refused."""
    lib = load()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.frag_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} ({msg})")
