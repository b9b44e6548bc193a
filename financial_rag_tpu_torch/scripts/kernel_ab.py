"""Time the redesigned kernels of two source trees in one process, A B B A.

    python -m financial_rag_tpu_torch.scripts.kernel_ab --other DIR [--out FILE]

``DIR`` holds another checkout's ``csrc/`` (for example the parent commit's
``financial_rag_tpu_torch/csrc``). Both trees are built into their own
libraries, and K2 (``frag_flash_attention``), K3 (``frag_fused_ffn``), K9
(``frag_causal_flash``) and K10 (``frag_flash_attention_bwd``) of each are
launched on the same inputs at the main path's shapes, the two libraries in
the order A, B, B, A, each timed twice: with CUDA events around a loop of
launches (``*_ms``, which at the smallest shapes is the host's launch rate)
and as the kernels' own device time under torch.profiler (``*_dev_ms``,
which is not), and their outputs are compared. The C entry points are called directly: their arguments have not
changed. K10's scratch is allocated at the larger of the two layouts (3
planes); K3 gets from each tree's own ``ops/fused_ffn.py`` (beside its
``csrc/``) the split of the I axis its wrapper would choose, and scratch of
that many f32 partials. Prints one JSON line with the card's name and power
limit; the GPU only.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
from pathlib import Path

import torch

from financial_rag_tpu_torch.ops import kernel_lib

# (label, B, S, heads) of K10: the train path's shapes and K11's local ones
K10_SHAPES = (("contrastive", 256, 128, 12), ("both encodes", 512, 128, 12),
              ("listwise", 256, 64, 12), ("uplift", 256, 32, 12), ("K2 table", 256, 512, 12),
              ("tp2 local", 32, 128, 6), ("tp4 local", 64, 128, 3), ("tp2 listwise", 64, 64, 6))
# (label, B, S, heads) of K2: the table's shape, the contrastive encode, a
# rerank batch, a query's encode, the listwise step's encode, and K11's local
# shapes. Keys are padded to seeded random lengths as in chip_smoke.py (row 0
# full).
K2_SHAPES = (("K2 table", 256, 512, 12), ("contrastive", 256, 128, 12), ("rerank", 64, 512, 12),
             ("query", 8, 64, 12), ("listwise", 256, 64, 12), ("tp2 local", 32, 128, 6),
             ("tp4 local", 64, 128, 3), ("tp2 listwise", 64, 64, 6))
# (label, N) of K3 at H=384, I=1,536: the table's shape, the training
# encode, a query's 8 x 64 tokens
K3_SHAPES = (("K3 table", 131072), ("train encode", 32768), ("query", 512))
# (label, B, S, pads) of K9 at the Qwen2-0.5B head shape (14 / 2 heads of 64)
K9_SHAPES = (("answer prompt", 1, 4096, (1100,)), ("normaliser", 1, 128, (60,)),
             ("generate_many", 3, 1024, (0, 300, 1023)))


def build_library(csrc: Path, out_dir: Path):
    """Build ``csrc`` with the port's build rules into ``out_dir``; return
    the loaded library with its C signatures set."""
    saved = kernel_lib.CSRC, os.environ.get("FRAG_KERNEL_BUILD_DIR")
    kernel_lib.CSRC = csrc.resolve()
    os.environ["FRAG_KERNEL_BUILD_DIR"] = str(out_dir)
    try:
        lib = ctypes.CDLL(str(kernel_lib.build()))
    finally:
        kernel_lib.CSRC = saved[0]
        if saved[1] is None:
            os.environ.pop("FRAG_KERNEL_BUILD_DIR", None)
        else:
            os.environ["FRAG_KERNEL_BUILD_DIR"] = saved[1]
    for name in ("frag_flash_attention", "frag_fused_ffn", "frag_flash_attention_bwd",
                 "frag_causal_flash"):
        fn = getattr(lib, name)
        fn.argtypes = kernel_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def cuda_ms(fn, iters: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """The device time of one call of ``fn``: every kernel it launches, from
    its start to its end on the card, under torch.profiler, averaged over
    ``iters`` calls. Gaps between launches do not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler saw no kernel of the call")
    return us / 1e3 / iters


def ffn_splits(csrc: Path, n: int, chunks: int, sms: int) -> int:
    """The I-axis split the wrapper beside ``csrc`` (its ``ops/fused_ffn.py``)
    chooses for n tokens: each tree's kernel is given the split it was
    tuned for."""
    spec = importlib.util.spec_from_file_location("kernel_ab_fused_ffn",
                                                  csrc.parent / "ops" / "fused_ffn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.split_count(-(-n // mod.KERNEL_TOKENS), chunks, sms)


def k2_call(lib, b: int, s: int, heads: int, gen):
    """(run, outputs): K2 on seeded inputs with keys padded to random
    lengths, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    q, k, v = (torch.randn(b, s, heads * 32, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = s
    bias = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(k), p(v), p(bias), p(out), b, s, heads * 32, heads, stream)

    def run():
        if lib.frag_flash_attention(*args):
            raise RuntimeError("frag_flash_attention refused the launch")
    run.tensors = (q, k, v, bias)   # args holds raw pointers into these
    return run, [out]


def k3_call(lib, n: int, splits: int, gen):
    """(run, outputs): K3 on seeded inputs at H=384, I=1,536 with ``splits``
    blocks per token tile, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    h, i = 384, 1536
    x = torch.randn(n, h, generator=gen, device="cuda").bfloat16()
    w1 = (torch.randn(h, i, generator=gen, device="cuda") * h ** -0.5).bfloat16()
    w2 = (torch.randn(i, h, generator=gen, device="cuda") * i ** -0.5).bfloat16()
    b1 = (torch.randn(i, generator=gen, device="cuda") * 0.1).bfloat16()
    b2 = (torch.randn(h, generator=gen, device="cuda") * 0.1).bfloat16()
    out = torch.empty_like(x)
    partial = torch.empty(splits, n, h, device="cuda") if splits > 1 else None
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(x), p(w1), p(b1), p(w2), p(b2), p(out), p(partial) if partial is not None else None,
            n, h, i, splits, stream)

    def run():
        if lib.frag_fused_ffn(*args):
            raise RuntimeError("frag_fused_ffn refused the launch")
    run.tensors = (x, w1, b1, w2, b2, partial)   # args holds raw pointers into these
    return run, [out]


def k10_call(lib, b: int, s: int, heads: int, gen):
    """(run, outputs): K10 on seeded inputs, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    q, k, v, do = (torch.randn(b, s, heads * 32, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    outs = [torch.empty_like(q) for _ in range(3)]
    stats = torch.empty(3, b, heads, s, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (*(p(t) for t in (q, k, v, bias, do, *outs, stats)), b, s, heads * 32, heads, stream)

    def run():
        if lib.frag_flash_attention_bwd(*args):
            raise RuntimeError("frag_flash_attention_bwd refused the launch")
    run.tensors = (q, k, v, bias, do, stats)   # args holds raw pointers into these
    return run, outs


def k9_call(lib, b: int, s: int, pads, gen):
    """(run, outputs): K9 on seeded inputs, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    q = torch.randn(b, s, 14 * 64, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s, 2 * 64, generator=gen, device="cuda").bfloat16() for _ in range(2))
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(k), p(v), p(pad), p(out), b, s, 14, 2, 64, kernel_lib.DTYPE_CODES[q.dtype],
            stream)

    def run():
        if lib.frag_causal_flash(*args):
            raise RuntimeError("frag_causal_flash refused the launch")
    run.tensors = (q, k, v, pad)   # args holds raw pointers into these
    return run, [out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="the other tree's csrc/ directory")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    root = kernel_lib.build_dir()
    trees = {"this": kernel_lib.CSRC, "other": Path(args.other).resolve()}
    libs = {name: build_library(csrc, root / f"ab_{name}") for name, csrc in trees.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    rows = []
    splits = {(tree, n): ffn_splits(csrc, n, 1536 // 32, sms)
              for tree, csrc in trees.items() for _, n in K3_SHAPES}
    # make(tree) -> (run, outputs) on that tree's library
    cases = [("K2", label, (b, s, h), lambda tree, b=b, s=s, h=h: k2_call(libs[tree], b, s, h, gen))
             for label, b, s, h in K2_SHAPES]
    cases += [("K3", label, {"N": n, "splits": {tree: splits[tree, n] for tree in trees}},
               lambda tree, n=n: k3_call(libs[tree], n, splits[tree, n], gen))
              for label, n in K3_SHAPES]
    cases += [("K10", label, (b, s, h), lambda tree, b=b, s=s, h=h: k10_call(libs[tree], b, s, h, gen))
              for label, b, s, h in K10_SHAPES]
    cases += [("K9", label, (b, s, list(pads)), lambda tree, b=b, s=s, pads=pads: k9_call(
        libs[tree], b, s, pads, gen)) for label, b, s, pads in K9_SHAPES]
    for kernel, label, shape, make in cases:
        runs, outs = {}, {}
        for name in libs:
            gen.manual_seed(0)   # the same inputs for both trees
            runs[name], outs[name] = make(name)
        ms, dev = {"this": [], "other": []}, {"this": [], "other": []}
        for name in ("this", "other", "other", "this"):
            ms[name].append(cuda_ms(runs[name]))
        for name in ("this", "other", "other", "this"):
            dev[name].append(device_ms(runs[name]))
        # the two trees' outputs on the same inputs: largest difference as a
        # share of the other tree's largest value
        rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                  for a, b in zip(outs["this"], outs["other"]))
        rows.append({"kernel": kernel, "case": label, "shape": shape, "this_ms": ms["this"],
                     "other_ms": ms["other"], "this_dev_ms": dev["this"],
                     "other_dev_ms": dev["other"], "max_rel_diff": rel})
    line = {"card": smi, "order": "this, other, other, this", "rows": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
