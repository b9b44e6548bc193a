"""torch.profiler capture of a whole window (counterpart of the JAX
package's jax.profiler ``profile_trace``). ``utils/timing.py``'s blocks are
``record_function`` ranges, so their labels (encoder.forward_*,
hybrid.search, ...) appear inside the capture."""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

from financial_rag_tpu_torch.utils.logging import get_logger

log = get_logger("utils.profiling")


@contextlib.contextmanager
def profile_trace(out_dir: str | Path = "profiles"):
    """Capture a torch.profiler trace around a code block and write it to
    ``out_dir`` as a Chrome trace (``trace_<pid>_<ns>.json``; open it in
    perfetto or chrome://tracing). Yields ``out_dir``. CUDA activity is
    recorded when a CUDA device is present."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield out
    finally:
        prof.stop()
        path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        log.info("profiler trace written to %s", path)
