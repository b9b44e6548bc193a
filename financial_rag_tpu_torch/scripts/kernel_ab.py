"""Time the redesigned kernels of two source trees in one process, A B B A.

    python -m financial_rag_tpu_torch.scripts.kernel_ab --other DIR [--out FILE]

``DIR`` holds another checkout's ``csrc/`` (for example the parent commit's
``financial_rag_tpu_torch/csrc``). Both trees are built into their own
libraries, and K1 (``frag_pool_norm``), K2 (``frag_flash_attention``), K3
(``frag_fused_ffn``), K4 (``frag_packed_topk``), K9 (``frag_causal_flash``)
and K10 (``frag_flash_attention_bwd``) of each are launched on the same
inputs at the main path's shapes, the two libraries in the order A, B, B,
A, each timed twice: with CUDA events around a loop of launches (``*_ms``,
which at the smallest shapes is the host's launch rate) and as the kernels'
own device time under torch.profiler (``*_dev_ms``, which is not); K4's
device time is also split into its sweep and its merge kernel
(``*_sweep_dev_ms``, ``*_merge_dev_ms``). The outputs are compared:
``max_abs_diff`` is the largest difference, ``max_rel_diff`` that as a
share of the other tree's largest value. K4's inputs are exact-grid data,
where every score is exact in f32, so two right trees agree to the bit.

The C entry points are called directly. Their arguments are the same in
both trees, but what a launch plan puts in them is each tree's own: K3 gets
from each tree's ``ops/fused_ffn.py`` (beside its ``csrc/``) the split of
the I axis its wrapper would choose, and scratch of that many f32 partials;
K4 gets from each tree's ``ops/topk.py`` its tile groups and scratch of that
many [Bqp, block_n] planes (a tree whose ``ops/topk.py`` predates
``packed_sweep_grid`` gets the 64-query, 16-column rule of its
``tile_groups``). K4's queries are passed padded to Bqp rows of zeros,
which both trees take. K10's scratch is allocated at the larger of the two
layouts (3 planes). Prints one JSON line with the card's name and power
limit; the GPU only.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
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
# (label, B, S, dtype) of K1 at H=384: the table's shape, the ingest's
# batches (3,482 children in 51 launches), a query's encode, and f32
K1_SHAPES = (("K1 table", 256, 512, "bf16"), ("ingest", 68, 512, "bf16"),
             ("ingest short", 68, 128, "bf16"), ("query", 8, 64, "bf16"),
             ("f32", 64, 512, "f32"))
# (label, Bq, N) of K4 at D=384, k=24, bf16: the table's shape, a query batch
# over the same corpus, the served shape (one query per launch over the
# smoke test's index capacity), a smaller corpus, and one tile (bits 1)
K4_SHAPES = (("K4 table", 128, 102400), ("batch of 8", 8, 102400), ("served", 1, 4096),
             ("N=16,384", 128, 16384), ("one tile", 128, 1024))
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
    for name in ("frag_pool_norm", "frag_flash_attention", "frag_fused_ffn", "frag_packed_topk",
                 "frag_flash_attention_bwd", "frag_causal_flash"):
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


def device_ms(fn, iters: int = 50) -> dict:
    """The device time of one call of ``fn`` by kernel name: every kernel it
    launches, from its start to its end on the card, under torch.profiler,
    averaged over ``iters`` calls. Gaps between launches do not count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        if sum(by_name.values()) > 0:
            return {name: us / 1e3 / iters for name, us in by_name.items()}
        print(f"kernel_ab: the profiler saw no kernel (attempt {attempt + 1}, "
              f"{len(prof.events())} events)", file=sys.stderr)
    raise RuntimeError("the profiler saw no kernel of the call")


def tree_module(csrc: Path, name: str):
    """The ops module ``name`` of the tree whose ``csrc/`` is given."""
    spec = importlib.util.spec_from_file_location(f"kernel_ab_{name}",
                                                  csrc.parent / "ops" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ffn_splits(csrc: Path, n: int, chunks: int, sms: int) -> int:
    """The I-axis split the wrapper beside ``csrc`` (its ``ops/fused_ffn.py``)
    chooses for n tokens: each tree's kernel is given the split it was
    tuned for."""
    mod = tree_module(csrc, "fused_ffn")
    return mod.split_count(-(-n // mod.KERNEL_TOKENS), chunks, sms)


def packed_plan(csrc: Path, bq: int, n: int, sms: int):
    """(Bqp, block_n, bits, tiles_per_group, groups) that K4's wrapper beside
    ``csrc`` (its ``ops/topk.py``) chooses for Bq queries over N rows."""
    mod = tree_module(csrc, "topk")
    if hasattr(mod, "packed_sweep_grid"):
        return mod.packed_sweep_grid(bq, n, sms)
    # before the bf16 sweep's redesign: 64-query, 16-column blocks
    block_n, ntiles, bits = mod._packing(n, 1024)
    bqp = mod.round_up(max(bq, 1), mod.KERNEL_QUERY_TILE)
    per_group = mod.tile_groups(
        ntiles, (block_n // mod.KERNEL_COLUMNS) * (bqp // mod.KERNEL_QUERY_TILE), sms)
    return bqp, block_n, bits, per_group, -(-ntiles // per_group)


def k1_call(lib, b: int, s: int, dtype: str, gen):
    """(run, outputs): K1 on seeded hidden states with rows padded to random
    lengths (row 0 full), through ``lib``'s C entry."""
    p = kernel_lib.ptr
    hidden = torch.randn(b, s, 384, generator=gen, device="cuda").to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = s
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None]).float()
    out = torch.empty(b, 384, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(hidden), p(mask), p(out), b, s, 384, kernel_lib.DTYPE_CODES[hidden.dtype], stream)

    def run():
        if lib.frag_pool_norm(*args):
            raise RuntimeError("frag_pool_norm refused the launch")
    run.tensors = (hidden, mask)   # args holds raw pointers into these
    return run, [out]


def k4_call(lib, bq: int, n: int, plan, gen, k: int = 24):
    """(run, outputs): K4 on seeded exact-grid data (every score exact in
    f32, with ties) at D=384 with 3% dead rows, queries padded with zeros to
    Bqp rows and scratch as ``plan`` says, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    bqp, block_n, bits, per_group, groups = plan
    q = torch.zeros(bqp, 384, dtype=torch.bfloat16, device="cuda")
    q[:bq] = (torch.randint(-3, 4, (bq, 384), generator=gen, device="cuda") / 64.0).bfloat16()
    x = (torch.randint(-3, 4, (n, 384), generator=gen, device="cuda") / 64.0).bfloat16()
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.03).float()
    b1 = torch.empty(groups, bqp, block_n, dtype=torch.int32, device="cuda")
    b2 = torch.empty_like(b1)
    out_s = torch.empty(bq, k, device="cuda")
    out_i = torch.empty(bq, k, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(x), p(valid), p(b1), p(b2), p(out_s), p(out_i), bq, bqp, n, 384, block_n,
            bits, k, per_group, kernel_lib.DTYPE_CODES[x.dtype], stream)

    def run():
        if lib.frag_packed_topk(*args):
            raise RuntimeError("frag_packed_topk refused the launch")
    run.tensors = (q, x, valid, b1, b2)   # args holds raw pointers into these
    return run, [out_s, out_i]


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
    plans = {(tree, bq, n): packed_plan(csrc, bq, n, sms)
             for tree, csrc in trees.items() for _, bq, n in K4_SHAPES}
    cases = [("K1", label, (b, s, dt), lambda tree, b=b, s=s, dt=dt: k1_call(libs[tree], b, s, dt, gen))
             for label, b, s, dt in K1_SHAPES]
    cases += [("K4", label, {"Bq": bq, "N": n, "groups": {tree: plans[tree, bq, n][4] for tree in trees}},
               lambda tree, bq=bq, n=n: k4_call(libs[tree], bq, n, plans[tree, bq, n], gen))
              for label, bq, n in K4_SHAPES]
    cases += [("K2", label, (b, s, h), lambda tree, b=b, s=s, h=h: k2_call(libs[tree], b, s, h, gen))
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
        # the two trees' outputs on the same inputs: largest difference, and
        # as a share of the other tree's largest value
        diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs["this"], outs["other"])]
        rel = max(d / b.float().abs().max().item() for d, b in zip(diffs, outs["other"]))
        row = {"kernel": kernel, "case": label, "shape": shape, "this_ms": ms["this"],
               "other_ms": ms["other"],
               "this_dev_ms": [sum(d.values()) for d in dev["this"]],
               "other_dev_ms": [sum(d.values()) for d in dev["other"]],
               "max_rel_diff": rel, "max_abs_diff": max(diffs)}
        if kernel == "K4":
            for name in ("this", "other"):
                for part in ("sweep", "merge"):
                    row[f"{name}_{part}_dev_ms"] = [
                        sum(t for kname, t in d.items() if part in kname) for d in dev[name]]
        rows.append(row)
    line = {"card": smi, "order": "this, other, other, this", "rows": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
