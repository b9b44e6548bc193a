"""Time K3's generic route under every launch plan it takes, at a query's tokens.

    python -m financial_rag_tpu_torch.scripts.k3_plans [--out FILE] [--tokens 512]

For each (H, I) of ``kernel_ab.K3_GENERIC_SHAPES``, at ``--tokens`` tokens
(a query's 512 by default), ``frag_fused_ffn_large`` of this tree runs
under every plan it takes: each product's tile columns 64, 128 or 256
(256 where ``wide_tiles_fit``), and the second product's k steps split 1
to ceil(I / 64) // LARGE_MIN_STEPS ways. Each plan's device time by kernel
(torch.profiler, ``kernel_ab.device_ms``) is printed beside the plan that
``large_launch_plan`` picks and the three-call yardstick (``F.linear``,
``F.gelu``, ``F.linear``) on the same inputs, and each plan's output is
held against ``fused_ffn_plain`` (``max_abs_err``). Prints one JSON line
with the card's name and power limit; the GPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from financial_rag_tpu_torch.ops import fused_ffn as ffn
from financial_rag_tpu_torch.ops import kernel_lib
from financial_rag_tpu_torch.scripts import kernel_ab


def plans(h: int, i: int):
    """Every (up_cols, down_cols, splits) the C entry takes at (H, I)."""
    def widths(cols):
        return [c for c in (ffn.LARGE_SLIM_COLS, ffn.LARGE_NARROW_COLS, ffn.LARGE_WIDE_COLS)
                if c != ffn.LARGE_WIDE_COLS or ffn.wide_tiles_fit(cols)]
    steps = -(-i // ffn.LARGE_DEPTH)
    return [(up, down, s) for up in widths(i) for down in widths(h)
            for s in range(1, max(1, steps // ffn.LARGE_MIN_STEPS) + 1)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--tokens", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_plans needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = kernel_ab.build_library(kernel_lib.CSRC, kernel_lib.build_dir() / "k3_plans")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    n = args.tokens
    rows = []
    for label, _, h, i in kernel_ab.K3_GENERIC_SHAPES:
        if any(r["H"] == h and r["I"] == i for r in rows):
            continue
        picked = ffn.large_launch_plan(n, i, sms, h)
        runs, outs = [], []
        for up, down, splits in plans(h, i):
            gen.manual_seed(0)   # the same inputs for every plan
            run, out = kernel_ab.k3_call(lib, n, h, {"splits": splits, "cols": (up, down)}, gen, i)
            runs.append(run)
            outs.append(out[0])
        x, w1, b1, w2, b2 = runs[0].tensors[:5]
        want = ffn.fused_ffn_plain(x, w1, b1, w2, b2).float()
        times = kernel_ab.device_ms(runs + [kernel_ab.three_call(runs[0].tensors)])
        for run in runs:   # the outputs of the timed calls
            run()
        torch.cuda.synchronize()
        for (up, down, splits), out, t in zip(plans(h, i), outs, times):
            rows.append({"case": label.replace("rerank", "").replace("ingest", "").strip(),
                         "N": n, "H": h, "I": i, "up_cols": up, "down_cols": down,
                         "splits": splits, "picked": (up, down, splits) == picked,
                         "dev_ms": sum(t.values()),
                         "parts_dev_ms": {k.replace("(anonymous namespace)::", "")
                                          .removeprefix("void ").split("(")[0]: v
                                          for k, v in t.items()},
                         "max_abs_err": (out.float() - want).abs().max().item()})
        rows.append({"case": "three calls", "N": n, "H": h, "I": i,
                     "dev_ms": sum(times[-1].values())})
    line = {"card": smi, "rows": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
