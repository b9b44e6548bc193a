"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: the device
comes from the argument, else from ``FRAG_PLATFORM`` (the JAX package's
existing variable; ``cpu`` means the CPU), else ``cuda``. A CUDA device on a
machine without one raises: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        plat = (os.environ.get("FRAG_PLATFORM") or "").strip().lower()
        device = "cpu" if plat == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or set FRAG_PLATFORM=cpu) to run on the CPU")
    return dev
