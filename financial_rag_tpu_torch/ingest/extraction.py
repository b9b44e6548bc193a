"""PDF extraction via the Marker CLI (out-of-scope for a native rebuild —
SURVEY.md §2.4: the JSON shapes are the contract).

Capability of reference extraction.py:15-133: shells out to
marker_single/marker with env-tunable flags (LLM-assisted extraction, OCR,
page ranges, device/worker counts). Degrades cleanly when the CLI is not
installed: sources that are already extraction JSONs are passed through.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

from financial_rag_tpu_torch.utils import get_logger

log = get_logger("ingest.extraction")

MARKER_ENV_FLAGS = [
    # (env var, CLI flag, is_boolean)
    ("MARKER_USE_LLM", "--use_llm", True),
    ("MARKER_FORCE_OCR", "--force_ocr", True),
    ("MARKER_STRIP_EXISTING_OCR", "--strip_existing_ocr", True),
    ("MARKER_DISABLE_IMAGE_EXTRACTION", "--disable_image_extraction", True),
    ("MARKER_PAGE_RANGE", "--page_range", False),
    ("MARKER_LANGUAGES", "--languages", False),
]

# multi-device batch extraction knobs passed through to marker_chunk_convert
# (reference extraction.py:111-118): these are environment variables of the
# Marker process itself, not CLI flags.
MARKER_PASSTHROUGH_ENV = ("NUM_DEVICES", "NUM_WORKERS", "TORCH_DEVICE")


def marker_available() -> Optional[str]:
    for cli in ("marker_single", "marker"):
        path = shutil.which(cli)
        if path:
            return cli
    return None


def run_marker_batch(input_dir: str | Path, output_dir: str | Path, *,
                     timeout_s: float = 7200.0) -> Path:
    """Batch extraction via marker_chunk_convert (multi-device capable —
    NUM_DEVICES/NUM_WORKERS env passthrough, reference extraction.py:111-118).
    Falls back to per-file run_marker when the batch CLI is missing."""
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cli = shutil.which("marker_chunk_convert")
    if cli is None:
        for p in sorted(input_dir.rglob("*")):
            if p.is_file():
                run_marker(p, output_dir / p.stem)
        return output_dir
    env_vars = dict(os.environ)  # NUM_DEVICES / NUM_WORKERS flow through
    cmd = [cli, str(input_dir), str(output_dir)]
    log.info("running marker_chunk_convert: %s (NUM_DEVICES=%s NUM_WORKERS=%s)",
             " ".join(cmd), env_vars.get("NUM_DEVICES"), env_vars.get("NUM_WORKERS"))
    subprocess.run(cmd, check=True, timeout=timeout_s, env=env_vars,
                   capture_output=True, text=True)
    return output_dir


def run_marker(input_path: str | Path, output_dir: str | Path, *,
               timeout_s: float = 1800.0) -> Path:
    """Extract one document to Marker JSON. Returns the output JSON path.

    If the input already is a .json extraction, it is copied through
    unchanged (lets the pipeline run in environments without Marker).
    """
    input_path = Path(input_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    if input_path.suffix.lower() == ".json":
        dest = output_dir / input_path.name
        if dest.resolve() != input_path.resolve():
            shutil.copy2(input_path, dest)
        return dest

    cli = marker_available()
    if cli is None:
        raise RuntimeError(
            "Marker CLI not installed and input is not a pre-extracted JSON; "
            "install marker-pdf or supply extraction JSONs")

    cmd: List[str] = [cli, str(input_path), "--output_format", "json",
                      "--output_dir", str(output_dir)]
    for env, flag, is_bool in MARKER_ENV_FLAGS:
        val = os.environ.get(env)
        if not val:
            continue
        if is_bool:
            if val.strip().lower() in ("1", "true", "yes"):
                cmd.append(flag)
        else:
            cmd.extend([flag, val])

    env_vars = dict(os.environ)
    log.info("running marker: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, timeout=timeout_s, env=env_vars,
                   capture_output=True, text=True)

    out = output_dir / f"{input_path.stem}.json"
    if not out.exists():
        nested = output_dir / input_path.stem / f"{input_path.stem}.json"
        if nested.exists():
            return nested
        raise FileNotFoundError(f"marker produced no JSON for {input_path}")
    return out
