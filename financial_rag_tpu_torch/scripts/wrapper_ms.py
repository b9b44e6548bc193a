"""Time the K1, K4 and K5 wrappers as a caller runs them, on the GPU.

    python financial_rag_tpu_torch/scripts/wrapper_ms.py [--out FILE]

Runs ``pool_norm.masked_mean_l2_normalize``, ``topk.packed_topk_fused`` and
``topk.bucketed_topk_fused`` (over an int8 corpus, as the int8 index calls
it) of the ``financial_rag_tpu_torch`` package found first on ``sys.path`` (so
``PYTHONPATH=DIR`` times another checkout's wrappers with this script) at
the main path's shapes: each call's Python checks, casts, scratch
allocation and ctypes launch, not only the kernels. A shape's time is the
median of 5 runs of 200 calls, host clock around the run and a
``torch.cuda.synchronize()`` after it, so where the host is slower than the
card it is the host's time per call. Prints one JSON line with the card's
name and power limit and the package's path.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

# (label, B, S) of K1 at H=384 bf16; (label, Bq, N) of K4 at D=384, k=24, bf16,
# and of K5 at D=384, k=24 over the int8 index's per-row quantized rows
K1_SHAPES = (("K1 table", 256, 512), ("ingest", 68, 512), ("query", 8, 64))
K4_SHAPES = (("K4 table", 128, 102400), ("batch of 8", 8, 102400), ("served", 1, 4096))
K5_SHAPES = (("K5 table", 128, 102400), ("served", 1, 4096))


def host_ms(fn, calls: int = 200, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_ms needs a CUDA GPU")
    import financial_rag_tpu_torch
    from financial_rag_tpu_torch.ops import pool_norm, topk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for label, b, s in K1_SHAPES:
        hidden = torch.randn(b, s, 384, generator=gen, device="cuda").bfloat16()
        lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
        rows.append({"kernel": "K1", "case": label, "shape": [b, s],
                     "ms": host_ms(lambda: pool_norm.masked_mean_l2_normalize(hidden, mask))})
    for label, bq, n in K4_SHAPES:
        x = torch.randn(n, 384, generator=gen, device="cuda")
        x = (x / x.norm(dim=1, keepdim=True)).bfloat16()
        q = torch.randn(bq, 384, generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = (torch.rand(n, generator=gen, device="cuda") > 0.03).float()
        rows.append({"kernel": "K4", "case": label, "shape": [bq, n],
                     "ms": host_ms(lambda: topk.packed_topk_fused(q, x, valid, 24))})
    for label, bq, n in K5_SHAPES:
        v = torch.randn(n, 384, generator=gen, device="cuda")
        v = v / v.norm(dim=1, keepdim=True)
        m = v.abs().amax(dim=1)
        x = torch.round(v * (127.0 / m[:, None])).clamp(-127, 127).to(torch.int8)
        valid = (m / 127.0) * (torch.rand(n, generator=gen, device="cuda") > 0.03).float()
        q = torch.randn(bq, 384, generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        rows.append({"kernel": "K5", "case": label, "shape": [bq, n],
                     "ms": host_ms(lambda: topk.bucketed_topk_fused(q, x, valid, 24))})
    line = {"card": smi, "package": str(Path(financial_rag_tpu_torch.__file__).parent),
            "rows": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
