"""Time the redesigned kernels of two source trees in one process, A B B A.

    python -m financial_rag_tpu_torch.scripts.kernel_ab --other DIR [--out FILE] [--only K5,K7]

``DIR`` holds another checkout's ``csrc/`` (for example the parent commit's
``financial_rag_tpu_torch/csrc``). Both trees are built into their own
libraries, and K1 (``frag_pool_norm``), K2 (``frag_flash_attention``), K3
(``frag_fused_ffn``), K4 (``frag_packed_topk``), K5 and K7
(``frag_bucketed_topk``), K6 (``frag_topk_exact``), K9
(``frag_causal_flash``) and K10 (``frag_flash_attention_bwd``) of each are
launched on the same inputs at the main path's shapes (K2, K3, K4, K5 and
K10 also at the bge-base width: heads of 64, hidden 768, D 768, K10 there
with every key live and with padded keys; K1, K2, K3, K4, K5 and K7 also at
the bge-large width: hidden 1,024, 16 heads of 64, D 1,024; K9 also at
heads of 128, Qwen2-1.5B's, Qwen2-7B's and Llama-3-8B's; K2, K3, K9 and K10
also on their generic routes: heads of 16, 26 and 48, K3 at (128, 512),
(312, 1,200), (512, 2,048) and (1,024, 4,000), K9 at heads of 80, 96 and
100, where a tree from before those routes is refused), the two libraries in
the order A, B, B, A, each timed twice: with CUDA events around a loop of
launches (``*_ms``, which at the smallest shapes is the host's launch rate)
and as the kernels' own device time under torch.profiler (``*_dev_ms``,
which is not); the device time of K4-K7 is also split into the
sweep and the merge kernel (``*_sweep_dev_ms``, ``*_merge_dev_ms``; K5's
merge is its extract, K7's its write kernel). K7's call is its wrapper's
work after the queries' cast: the C entry, then the stable sort that takes
the top k of the bucket maxima, whose device time is ``*_sort_dev_ms``.
The outputs are compared: ``max_abs_diff`` is the
largest difference, ``max_rel_diff`` that as a share of the other tree's
largest value. The sweeps' inputs are exact-grid data, where every score
is exact in f32, so two right trees agree to the bit.

The C entry points are called directly. Their arguments are the same in
both trees, but for the true head_dim that K2, K9 and K10 take and the
hidden width that ``frag_fused_ffn_large`` takes since the generic routes
(a tree without ``ops/common.pad_heads`` is called without them), and what
a launch plan puts in them is each tree's own. A generic-route case runs
what the tree's wrapper runs: at the widths its ``fwd_reads_in_place``
(K2), ``bwd_reads_in_place`` (K10) or ``causal_reads_in_place`` (K9)
names, the C entry on the heads where they lie; elsewhere, and in a tree
without that rule, the heads' zero-padded copies, the C entry, the padded
columns dropped, so its device time includes the copies. The generic
shapes of K2, K10 and K9 also run as the kernel alone on inputs padded
once beforehand ("kernel alone" rows), and K10 and K9 at their tuned
widths (32 / 64 and 64 / 128) at the generic rows' shapes. K3 gets
from each tree's ``ops/fused_ffn.py`` (beside its ``csrc/``) the split of
the I axis its wrapper would choose (its ``launch_plan``), and scratch of
that many f32 partials; at hidden 1,024 a tree whose wrapper has
``large_launch_plan`` (two products through h in device memory) is called
through ``frag_fused_ffn_large`` with that plan's tile widths and split, an
[N, I] bf16 h and its partials, an older one through ``frag_fused_ffn``.
K3's rows also time its three-call yardstick on the same inputs
(``F.linear``, ``F.gelu``, ``F.linear``: cuBLAS, the GELU pass, cuBLAS) as
``three_call_dev_ms``, after the trees' loops under the same profiler, and
split each tree's device time by kernel (``*_parts_dev_ms``);
K4-K7 get from each tree's ``ops/topk.py`` their tile or round
groups and scratch of that size (a tree whose ``ops/topk.py``
predates ``packed_sweep_grid``, ``bucketed_sweep_grid``,
``bucketed_launch_plan`` or ``exact_sweep_grid`` gets the rule of its
wrapper at the time: K4's, K5's and K7's 64-query, 16-column
``tile_groups``, K6's ``exact_groups``). The
sweeps' queries are passed padded to Bqp rows of zeros, which both trees
take. K10's scratch is allocated at the larger of the two
layouts (3 planes). A shape that one tree's kernel refuses (a tree from
before K10 took heads of 64) is timed in the other tree alone: the refusing
tree's times and the difference are null, and ``refused`` names it.
Prints one JSON line with the card's name and power limit; the GPU only.
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
from financial_rag_tpu_torch.ops.causal_flash import KERNEL_HEAD_DIMS as CAUSAL_HEAD_DIMS
from financial_rag_tpu_torch.ops.common import built_head_dim, pad_heads, unpad_heads
from financial_rag_tpu_torch.ops.flash_attention import BWD_HEAD_DIMS, FWD_HEAD_DIMS

# (label, B, S, heads, head_dim) of K10: the train path's shapes and K11's
# local ones, at heads of 32 and, for the bge-base width, of 64 (the
# contrastive and listwise encodes, K2's table shape, the feedback
# fine-tune's 100-token pairs, and the local heads of a dp2 x tp2 and a
# dp1 x tp4 contrastive encode)
K10_SHAPES = (("contrastive", 256, 128, 12, 32), ("both encodes", 512, 128, 12, 32),
              ("listwise", 256, 64, 12, 32), ("uplift", 256, 32, 12, 32),
              ("K2 table", 256, 512, 12, 32), ("tp2 local", 32, 128, 6, 32),
              ("tp4 local", 64, 128, 3, 32), ("tp2 listwise", 64, 64, 6, 32),
              ("wide contrastive", 256, 128, 12, 64), ("wide listwise", 256, 64, 12, 64),
              ("wide S=512", 256, 512, 12, 64), ("wide feedback", 256, 100, 12, 64),
              ("wide tp2 local", 32, 128, 6, 64), ("wide tp4 local", 64, 128, 3, 64))
# K10 at the bge-base width with keys padded to seeded random lengths, as
# chip_smoke.py pads them (row 0 full): the shapes above whose dead key
# tiles a kernel may skip
K10_PADDED_SHAPES = (("wide contrastive padded", 256, 128, 12, 64),
                     ("wide S=512 padded", 256, 512, 12, 64))
# (label, B, S, heads, head_dim) of K2: the table's shape, the contrastive
# encode, a rerank batch, a query's encode, the listwise step's encode, K11's
# local shapes, and the bge-base width's 12 heads of 64 at the table's shape,
# the wide ingest's batch (68 x 512, the most launched), the contrastive
# encode's, a query's and K11's local heads of 64. Keys are padded to seeded
# random lengths as in chip_smoke.py (row 0 full).
K2_SHAPES = (("K2 table", 256, 512, 12, 32), ("contrastive", 256, 128, 12, 32),
             ("rerank", 64, 512, 12, 32), ("query", 8, 64, 12, 32), ("listwise", 256, 64, 12, 32),
             ("tp2 local", 32, 128, 6, 32), ("tp4 local", 64, 128, 3, 32),
             ("tp2 listwise", 64, 64, 6, 32), ("wide table", 256, 512, 12, 64),
             ("wide ingest", 68, 512, 12, 64), ("wide S=128", 256, 128, 12, 64),
             ("wide query", 8, 64, 12, 64), ("wide tp2 local", 32, 128, 6, 64),
             ("wide tp4 local", 64, 128, 3, 64), ("large table", 256, 512, 16, 64),
             ("large ingest", 68, 512, 16, 64), ("large query", 8, 64, 16, 64))
# (label, N, H) of K3 with I = 4H: at H=384 the table's shape, the training
# encode and a query's 8 x 64 tokens; at H=768 (bge-base) and H=1,024
# (bge-large) the table's shape, the wide ingest's batch (68 x 512) and a
# query's
K3_SHAPES = (("K3 table", 131072, 384), ("train encode", 32768, 384), ("query", 512, 384),
             ("wide table", 131072, 768), ("wide ingest", 34816, 768), ("wide query", 512, 768),
             ("large table", 131072, 1024), ("large ingest", 34816, 1024),
             ("large query", 512, 1024))
# (label, N, H, I) of K3's generic route: TinyBERT-L-4's reranker (a 64 x
# 512 rerank batch and a query's 512 tokens), TinyBERT-L-2's, BERT-Small's
# and hidden 1,024 with I not whole 64-steps, each at a rerank batch or an
# ingest's and at a query's 512 tokens
K3_GENERIC_SHAPES = (("TinyBERT-L-4 rerank", 32768, 312, 1200),
                     ("TinyBERT-L-4 query", 512, 312, 1200),
                     ("TinyBERT-L-2 rerank", 32768, 128, 512), ("TinyBERT-L-2 query", 512, 128, 512),
                     ("BERT-Small ingest", 32768, 512, 2048), ("BERT-Small query", 512, 512, 2048),
                     ("1024 / 4000", 32768, 1024, 4000), ("1024 / 4000 query", 512, 1024, 4000))
# (label, B, S, heads, head_dim) of K2's and K10's generic route: TinyBERT-L-4's
# 12 heads of 26 at a 64 x 512 rerank batch and a query's 8 x 64, and 12 heads
# of 16 and 48
K2_GENERIC_SHAPES = (("TinyBERT-L-4 rerank", 64, 512, 12, 26), ("TinyBERT-L-4 query", 8, 64, 12, 26),
                     ("heads of 16", 64, 512, 12, 16), ("heads of 48", 64, 512, 12, 48),
                     ("heads of 16 query", 8, 64, 12, 16), ("heads of 48 query", 8, 64, 12, 48))
K10_GENERIC_SHAPES = (("TinyBERT-L-4 rerank step", 64, 128, 12, 26),
                      ("heads of 26 S=512", 64, 512, 12, 26), ("heads of 16", 64, 512, 12, 16),
                      ("heads of 48", 64, 512, 12, 48), ("heads of 48 S=128", 64, 128, 12, 48))
# K10 at its tuned widths at the generic rows' shapes (the two kernels at 32
# and 64, the fused kernel at 64)
K10_TUNED_SHAPES = (("heads of 32 S=512", 64, 512, 12, 32), ("heads of 64 S=512", 64, 512, 12, 64),
                    ("heads of 64 S=128", 64, 128, 12, 64))
# (label, B, S, dtype, H) of K1: at H=384 the table's shape, the ingest's
# batches (3,482 children in 51 launches), a query's encode, and f32; at
# H=1,024 the table's shape and the ingest's batch
K1_SHAPES = (("K1 table", 256, 512, "bf16", 384), ("ingest", 68, 512, "bf16", 384),
             ("ingest short", 68, 128, "bf16", 384), ("query", 8, 64, "bf16", 384),
             ("f32", 64, 512, "f32", 384), ("large table", 256, 512, "bf16", 1024),
             ("large ingest", 68, 512, "bf16", 1024))
# (label, Bq, N, D) of K4 at k=24, bf16: at D=384 the table's shape, a query
# batch over the same corpus, the served shape (one query per launch over
# the smoke test's index capacity), a smaller corpus, and one tile (bits 1);
# at D=768 the table's shape, the batch of 8 and the batcher's wave of 192;
# at D=1,024 those and one query over the table's corpus
K4_SHAPES = (("K4 table", 128, 102400, 384), ("batch of 8", 8, 102400, 384),
             ("served", 1, 4096, 384), ("N=16,384", 128, 16384, 384), ("one tile", 128, 1024, 384),
             ("D=768 table", 128, 102400, 768), ("D=768 batch of 8", 8, 102400, 768),
             ("D=768 wave", 192, 4096, 768), ("D=1024 table", 128, 102400, 1024),
             ("D=1024 batch of 8", 8, 102400, 1024), ("D=1024 one query", 1, 102400, 1024),
             ("D=1024 wave", 192, 4096, 1024))
# (label, Bq, N, dtype, D) of K5 at k=24, 4,096 buckets: at D=384 int8 (the
# int8 index's sweep) at the table's shape, a query batch and the served
# shape (one query per launch over the smoke test's index capacity), and
# bf16 at the table's; at D=768 and D=1,024 the table's and the served
# shape, int8 and bf16
K5_SHAPES = (("K5 table", 128, 102400, "int8", 384), ("batch of 8", 8, 102400, "int8", 384),
             ("served", 1, 4096, "int8", 384), ("bf16 table", 128, 102400, "bf16", 384),
             ("D=768 table", 128, 102400, "int8", 768), ("D=768 served", 1, 4096, "int8", 768),
             ("D=768 bf16 table", 128, 102400, "bf16", 768),
             ("D=768 bf16 served", 1, 4096, "bf16", 768),
             ("D=1024 table", 128, 102400, "int8", 1024), ("D=1024 served", 1, 4096, "int8", 1024),
             ("D=1024 bf16 table", 128, 102400, "bf16", 1024),
             ("D=1024 bf16 served", 1, 4096, "bf16", 1024))
# (label, Bq, N, dtype, D) of K7 at k=24, 4,096 buckets (backend
# pallas_bucketed): at D=384 the table's shape in bf16 and int8, and the
# backends phase's 9 questions over the index capacity; at D=1,024 the
# table's shape in bf16 and int8
K7_SHAPES = (("K7 table", 128, 102400, "bf16", 384), ("int8 table", 128, 102400, "int8", 384),
             ("backends", 9, 4096, "bf16", 384), ("D=1024 table", 128, 102400, "bf16", 1024),
             ("D=1024 int8 table", 128, 102400, "int8", 1024))
# (label, Bq, N, dtype, k, order) of K6 at D=384: the table's shape, int8 at
# N=16,384, the backends phase's 9 questions over the index capacity, k=128,
# and a corpus whose every row outscores the one before (every key passes
# the filter)
K6_SHAPES = (("K6 table", 128, 102400, "bf16", 24, "grid"),
             ("int8 N=16,384", 128, 16384, "int8", 24, "grid"),
             ("backends", 9, 4096, "bf16", 24, "grid"),
             ("k=128", 128, 102400, "bf16", 128, "grid"),
             ("ascending", 128, 16384, "bf16", 24, "ascending"))
# (label, B, S, pads, query heads, kv heads, head_dim[, dtype]) of K9: at the
# Qwen2-0.5B head shape (14 / 2 heads of 64), then at heads of 128 (Qwen2-1.5B's
# 12 / 2 at the served answer prompt and at pad 0, Qwen2-7B's 28 / 4,
# Llama-3-8B's 32 / 8), the generic route's heads (100, 96, 80), 32 / 32
# heads of 64 and 128, and f32 (LLM_DTYPE=float32) at 100, 64 and 128
K9_SHAPES = (("answer prompt", 1, 4096, (1100,), 14, 2, 64), ("normaliser", 1, 128, (60,), 14, 2, 64),
             ("generate_many", 3, 1024, (0, 300, 1023), 14, 2, 64),
             ("Qwen2-1.5B answer prompt", 1, 4096, (1100,), 12, 2, 128),
             ("Qwen2-1.5B pad 0", 1, 4096, (0,), 12, 2, 128),
             ("Qwen2-7B pad 0", 1, 4096, (0,), 28, 4, 128),
             ("Llama-3-8B pad 0", 1, 4096, (0,), 32, 8, 128),
             ("open_llama_3b answer prompt", 1, 4096, (1100,), 32, 32, 100),
             ("heads of 96", 1, 4096, (1100,), 32, 32, 96),
             ("heads of 80", 1, 4096, (1100,), 32, 32, 80),
             ("open_llama_3b f32 normaliser", 1, 128, (60,), 32, 32, 100, "f32"),
             ("heads of 64 at 32 / 32", 1, 4096, (1100,), 32, 32, 64),
             ("heads of 128 at 32 / 32", 1, 4096, (1100,), 32, 32, 128),
             ("f32 answer prompt", 1, 4096, (1100,), 14, 2, 64, "f32"),
             ("f32 normaliser", 1, 128, (60,), 14, 2, 64, "f32"),
             ("Qwen2-1.5B f32 answer prompt", 1, 4096, (1100,), 12, 2, 128, "f32"))
# the K9 rows whose heads are narrower than a built width, also run as the
# kernel alone on inputs padded once beforehand
K9_GENERIC_LABELS = ("open_llama_3b answer prompt", "heads of 96", "heads of 80",
                     "open_llama_3b f32 normaliser")


# the C entries that took one more int (the last but the stream) with the generic routes
GENERIC_ENTRIES = ("frag_flash_attention", "frag_flash_attention_bwd", "frag_causal_flash",
                   "frag_fused_ffn_large")

# the name fragments of each sweep's two kernels: its sweep and its merge
SWEEP_PARTS = {"K4": ("sweep", "merge"), "K5": ("sweep", "extract"), "K6": ("sweep", "merge"),
               "K7": ("sweep", "write")}


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
    # a tree from before the generic routes: no true head_dim (K2, K9, K10)
    # and no hidden width (frag_fused_ffn_large) argument
    lib.generic_widths = hasattr(tree_module(csrc, "common"), "pad_heads")
    # the widths whose heads the tree's K2 wrapper passes in place (none
    # before the rule: every narrower head is padded in a copy)
    attention = tree_module(csrc, "flash_attention")
    lib.fwd_in_place = getattr(attention, "fwd_reads_in_place", lambda head_dim, s, h: False)
    lib.bwd_in_place = getattr(attention, "bwd_reads_in_place", lambda head_dim, h: False)
    lib.causal_in_place = getattr(tree_module(csrc, "causal_flash"), "causal_reads_in_place",
                                  lambda head_dim, hq, hkv, dtype: False)
    for name in ("frag_pool_norm", "frag_flash_attention", "frag_fused_ffn", "frag_packed_topk",
                 "frag_bucketed_topk", "frag_topk_exact", "frag_flash_attention_bwd",
                 "frag_causal_flash", "frag_fused_ffn_large"):
        fn = getattr(lib, name, None)
        if fn is None:   # an entry the tree predates
            continue
        sig = kernel_lib._SIGNATURES[name]
        if not lib.generic_widths and name in GENERIC_ENTRIES:
            sig = sig[:-2] + sig[-1:]
        fn.argtypes = sig
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


def device_ms(fns, iters: int = 50) -> list:
    """The device time of one call of each of ``fns`` by kernel name: every
    kernel it launches, from its start to its end on the card, averaged
    over ``iters`` calls (gaps between launches do not count). All the
    loops run under one torch.profiler session, behind a spin kernel
    (``torch.cuda._sleep``) and each followed by one, which mark where each
    loop's kernels begin and end: one session a row, not one a loop, since
    in a process that had opened some 270 sessions the profiler recorded no
    kernel at all. A session also drops its first records, 1 to ~100 of
    them (more in a long-lived process), whatever it waits first: 256 small
    elementwise kernels go ahead of the first marker to be dropped instead.
    Each loop follows one call of its own between markers, which counts the
    kernels of a call; a session that misses a marker, or whose loop holds
    other than ``iters`` times that count, is made again twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    ahead = torch.zeros(1, device="cuda")
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(256):
                ahead.add_(1.0)
            torch.cuda._sleep(1000)
            for fn in fns:
                fn()
                torch.cuda._sleep(1000)
                for _ in range(iters):
                    fn()
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        groups = [[]]
        for e in kernels:
            if "spin_kernel" in e.name:
                groups.append([])
            else:
                groups[-1].append(e)
        # between the first marker and the last: each fn's one call, then its loop
        ones, loops = groups[1:-1:2], groups[2:-1:2]
        if len(groups) == 2 * len(fns) + 2 and all(
                ones[i] and len(loops[i]) == iters * len(ones[i]) for i in range(len(fns))):
            out = []
            for loop in loops:
                ms = {}
                for e in loop:
                    ms[e.name] = ms.get(e.name, 0.0) + (
                        e.time_range.end - e.time_range.start) / 1e3 / iters
                out.append(ms)
            return out
        print(f"kernel_ab: the profiler saw {len(kernels)} kernels and {len(groups) - 1} of "
              f"{2 * len(fns) + 1} markers, loops of {[len(g) for g in loops]} records for "
              f"calls of {[len(g) for g in ones]} (attempt {attempt + 1})", file=sys.stderr)
    raise RuntimeError("the profiler missed kernels of a call")


def launches(fn) -> bool:
    """Whether the tree's C entry takes the call (``fn`` raises where it
    returns an error, as a tree built before a width was added does)."""
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError:
        return False
    return True


def tree_module(csrc: Path, name: str):
    """The ops module ``name`` of the tree whose ``csrc/`` is given."""
    spec = importlib.util.spec_from_file_location(f"kernel_ab_{name}",
                                                  csrc.parent / "ops" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ffn_plan(csrc: Path, n: int, h: int, sms: int, i: int = 0) -> dict:
    """The launch the wrapper beside ``csrc`` (its ``ops/fused_ffn.py``)
    chooses for n tokens at hidden h, I = i (4h by default), so that each
    tree's kernel is given the plan it was tuned for: ``{"splits": s}``
    for ``frag_fused_ffn`` (a tree before the 768 design has no
    ``launch_plan`` and only the 384 rule; a tree without a design for h
    gets 1, and its kernel refuses the shape), or, at 1,024 in a tree with
    ``large_launch_plan`` and on the generic route of a tree with
    ``kernel_route``, ``{"splits": s, "cols": (up_cols, down_cols)}`` for
    ``frag_fused_ffn_large``."""
    i = i or 4 * h
    mod = tree_module(csrc, "fused_ffn")
    if hasattr(mod, "kernel_route"):
        route = mod.kernel_route(h, i)
        if route in ("large", "generic"):
            up_cols, down_cols, splits = mod.large_launch_plan(n, i, sms, h)
            return {"splits": splits, "cols": (up_cols, down_cols)}
        return {"splits": mod.launch_plan(n, h, i, sms)[2] if route else 1}
    tiling = getattr(mod, "KERNEL_TILING", None)
    if tiling is not None and h not in tiling:
        return {"splits": 1}
    if h == 1024 and hasattr(mod, "large_launch_plan"):
        up_cols, down_cols, splits = mod.large_launch_plan(n, i, sms)
        return {"splits": splits, "cols": (up_cols, down_cols)}
    if hasattr(mod, "launch_plan"):
        return {"splits": mod.launch_plan(n, h, i, sms)[2]}
    return {"splits": mod.split_count(-(-n // mod.KERNEL_TOKENS), i // mod.KERNEL_CHUNK, sms)}


def packed_plan(csrc: Path, bq: int, n: int, sms: int, d: int = 384):
    """(Bqp, block_n, bits, tiles_per_group, groups) that K4's wrapper beside
    ``csrc`` (its ``ops/topk.py``) chooses for Bq queries over N rows of D."""
    mod = tree_module(csrc, "topk")
    if hasattr(mod, "packed_sweep_grid"):
        if d != 384:
            return mod.packed_sweep_grid(bq, n, sms, d=d)
        return mod.packed_sweep_grid(bq, n, sms)
    # before the bf16 sweep's redesign: 64-query, 16-column blocks
    block_n, ntiles, bits = mod._packing(n, 1024)
    bqp = mod.round_up(max(bq, 1), mod.KERNEL_QUERY_TILE)
    per_group = mod.tile_groups(
        ntiles, (block_n // mod.KERNEL_COLUMNS) * (bqp // mod.KERNEL_QUERY_TILE), sms)
    return bqp, block_n, bits, per_group, -(-ntiles // per_group)


def bucketed_plan(csrc: Path, bq: int, n: int, sms: int, nbuckets: int = 4096,
                  row_bytes: int = 768):
    """(Bqp, rounds_per_group, groups) that K5's wrapper beside ``csrc``
    chooses for Bq queries over N int8 or bf16 rows, padded to ``row_bytes``
    (a tree before the D 768 sweeps sized its ring for 384 features)."""
    mod = tree_module(csrc, "topk")
    if hasattr(mod, "bucketed_sweep_grid"):
        if row_bytes != 768:
            return mod.bucketed_sweep_grid(bq, n, nbuckets, sms, row_bytes)
        return mod.bucketed_sweep_grid(bq, n, nbuckets, sms)
    # before the int8 sweep's redesign: 64-query, 16-column blocks
    bqp = mod.round_up(max(bq, 1), mod.KERNEL_QUERY_TILE)
    rounds = -(-n // nbuckets)
    per_group = mod.tile_groups(
        rounds, (nbuckets // mod.KERNEL_COLUMNS) * (bqp // mod.KERNEL_QUERY_TILE), sms)
    return bqp, per_group, -(-rounds // per_group)


def bucketed_topk_plan(csrc: Path, bq: int, n: int, sms: int, nbuckets: int = 4096,
                       row_bytes: int = 768):
    """(Bqp, rounds_per_group, groups) that K7's wrapper beside ``csrc``
    chooses for Bq queries over N int8 or bf16 rows padded to ``row_bytes``."""
    mod = tree_module(csrc, "topk")
    if hasattr(mod, "bucketed_launch_plan"):
        if row_bytes != 768:
            return mod.bucketed_launch_plan(bq, n, nbuckets, sms, hopper=True,
                                            row_bytes=row_bytes)
        return mod.bucketed_launch_plan(bq, n, nbuckets, sms, hopper=True)
    # before K7 took the Hopper sweep: 64-query, 16-column blocks
    bqp = mod.round_up(max(bq, 1), mod.KERNEL_QUERY_TILE)
    rounds = -(-n // nbuckets)
    per_group = mod.tile_groups(
        rounds, (nbuckets // mod.KERNEL_COLUMNS) * (bqp // mod.KERNEL_QUERY_TILE), sms)
    return bqp, per_group, -(-rounds // per_group)


def exact_plan(csrc: Path, bq: int, n: int, k: int, dtype, sms: int):
    """(Bqp, cols_per_group, groups, scratch keys) that K6's wrapper beside
    ``csrc`` chooses for Bq queries over N int8 or bf16 rows."""
    mod = tree_module(csrc, "topk")
    kcap = -(-k // 32) * 32
    if hasattr(mod, "exact_sweep_grid"):
        bqp, rows, per_group, groups = mod.exact_sweep_grid(bq, n, sms)
        keys = (mod.exact_scratch_keys(dtype, groups, bqp, kcap)
                if hasattr(mod, "exact_scratch_keys") else groups * bqp * kcap)
        return bqp, per_group * rows, groups, keys
    # before the exact sweep's redesign: 128-column chunks, merge cap
    bqp = mod.round_up(max(bq, 1), mod.KERNEL_QUERY_TILE)
    nchunks = n // mod.EXACT_CHUNK
    per_group = mod.exact_groups(nchunks, bqp // mod.KERNEL_QUERY_TILE, k, sms)
    groups = -(-nchunks // per_group)
    return bqp, per_group * mod.EXACT_CHUNK, groups, groups * bqp * kcap


def k1_call(lib, b: int, s: int, dtype: str, gen, h: int = 384):
    """(run, outputs): K1 on seeded hidden states of width h with rows
    padded to random lengths (row 0 full), through ``lib``'s C entry."""
    p = kernel_lib.ptr
    hidden = torch.randn(b, s, h, generator=gen, device="cuda").to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = s
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None]).float()
    out = torch.empty(b, h, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(hidden), p(mask), p(out), b, s, h, kernel_lib.DTYPE_CODES[hidden.dtype], stream)

    def run():
        if lib.frag_pool_norm(*args):
            raise RuntimeError("frag_pool_norm refused the launch")
    run.tensors = (hidden, mask)   # args holds raw pointers into these
    return run, [out]


def k4_call(lib, bq: int, n: int, d: int, plan, gen, k: int = 24):
    """(run, outputs): K4 on seeded exact-grid data (every score exact in
    f32, with ties) at D features with 3% dead rows, queries padded with
    zeros to Bqp rows and scratch as ``plan`` says, through ``lib``'s C
    entry."""
    p = kernel_lib.ptr
    bqp, block_n, bits, per_group, groups = plan
    q = torch.zeros(bqp, d, dtype=torch.bfloat16, device="cuda")
    q[:bq] = (torch.randint(-3, 4, (bq, d), generator=gen, device="cuda") / 64.0).bfloat16()
    x = (torch.randint(-3, 4, (n, d), generator=gen, device="cuda") / 64.0).bfloat16()
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.03).float()
    b1 = torch.empty(groups, bqp, block_n, dtype=torch.int32, device="cuda")
    b2 = torch.empty_like(b1)
    out_s = torch.empty(bq, k, device="cuda")
    out_i = torch.empty(bq, k, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(x), p(valid), p(b1), p(b2), p(out_s), p(out_i), bq, bqp, n, d, block_n,
            bits, k, per_group, kernel_lib.DTYPE_CODES[x.dtype], stream)

    def run():
        if lib.frag_packed_topk(*args):
            raise RuntimeError("frag_packed_topk refused the launch")
    run.tensors = (q, x, valid, b1, b2)   # args holds raw pointers into these
    return run, [out_s, out_i]


def sweep_inputs(bq: int, bqp: int, n: int, dtype: str, gen, order: str = "grid", d: int = 384):
    """Exact-grid queries padded with zeros to Bqp rows, corpus [N, D]
    (int8: integer rows; bf16: the grid) with a tile repeated in the next,
    and weights with 3% dead rows (int8: 0.01 a live row). ``ascending``:
    row j scores j for every query."""
    if order == "ascending":
        j = torch.arange(n, device="cuda")[:, None]
        x = (j - 127 * torch.arange(d, device="cuda")[None, :]).clamp(0, 127).float() / 64.0
        qv = torch.ones(bq, d, device="cuda") / 64.0
    else:
        x = torch.randint(-3, 4, (n, d), generator=gen, device="cuda").float() / 64.0
        if n >= 2048:
            x[1024:2048] = x[:1024]
        qv = torch.randint(-3, 4, (bq, d), generator=gen, device="cuda").float() / 64.0
    valid = (torch.rand(n, generator=gen, device="cuda") > 0.03).float()
    if dtype == "int8":
        x, valid = (x * 64).to(torch.int8), valid * 0.01
        qv = qv * 64
    else:
        x = x.bfloat16()
    q = torch.zeros(bqp, d, dtype=x.dtype, device="cuda")
    q[:bq] = qv.to(x.dtype)
    return q, x, valid


def k5_call(lib, bq: int, n: int, dtype: str, d: int, plan, gen, k: int = 24,
            nbuckets: int = 4096):
    """(run, outputs): K5 on exact-grid data (``sweep_inputs``) of D
    features with scratch as ``plan`` says, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    bqp, per_group, groups = plan
    q, x, valid = sweep_inputs(bq, bqp, n, dtype, gen, d=d)
    keys = torch.empty(groups, bqp, nbuckets, dtype=torch.int64, device="cuda")
    out_s = torch.empty(bq, k, device="cuda")
    out_i = torch.empty(bq, k, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(x), p(valid), p(keys), p(out_s), p(out_i), bq, bqp, n, d, nbuckets, k,
            per_group, kernel_lib.DTYPE_CODES[x.dtype], stream)

    def run():
        if lib.frag_bucketed_topk(*args):
            raise RuntimeError("frag_bucketed_topk refused the launch")
    run.tensors = (q, x, valid, keys)   # args holds raw pointers into these
    return run, [out_s, out_i]


def k7_call(lib, bq: int, n: int, dtype: str, plan, gen, k: int = 24, nbuckets: int = 4096,
            d: int = 384):
    """(run, outputs): K7 on exact-grid data (``sweep_inputs``) of D
    features with scratch as ``plan`` says, through ``lib``'s C entry, then
    the wrapper's stable top k of the [Bq, nbuckets] maxima; the outputs are
    the maxima."""
    from financial_rag_tpu_torch.ops import topk

    p = kernel_lib.ptr
    bqp, per_group, groups = plan
    q, x, valid = sweep_inputs(bq, bqp, n, dtype, gen, d=d)
    keys = torch.empty(groups, bqp, nbuckets, dtype=torch.int64, device="cuda")
    out_s = torch.empty(bq, nbuckets, device="cuda")
    out_i = torch.empty(bq, nbuckets, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(x), p(valid), p(keys), p(out_s), p(out_i), bq, bqp, n, d, nbuckets, 0,
            per_group, kernel_lib.DTYPE_CODES[x.dtype], stream)

    def run():
        if lib.frag_bucketed_topk(*args):
            raise RuntimeError("frag_bucketed_topk refused the launch")
        topk._stable_topk(out_s, out_i, k)
    run.tensors = (q, x, valid, keys)   # args holds raw pointers into these
    return run, [out_s, out_i]


def k6_call(lib, bq: int, n: int, dtype: str, k: int, order: str, plan, gen):
    """(run, outputs): K6 on ``sweep_inputs`` data with scratch as ``plan``
    says, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    bqp, cols_per_group, groups, keys = plan
    q, x, valid = sweep_inputs(bq, bqp, n, dtype, gen, order)
    kcap = -(-k // 32) * 32
    lists = torch.empty(keys, dtype=torch.int64, device="cuda")
    out_s = torch.empty(bq, k, device="cuda")
    out_i = torch.empty(bq, k, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(x), p(valid), p(lists), p(out_s), p(out_i), bq, bqp, n, 384, k, kcap,
            cols_per_group, n - 1024, kernel_lib.DTYPE_CODES[x.dtype], stream)

    def run():
        if lib.frag_topk_exact(*args):
            raise RuntimeError("frag_topk_exact refused the launch")
    run.tensors = (q, x, valid, lists)   # args holds raw pointers into these
    return run, [out_s, out_i]


def padded_run(lib, entry: str, ins, outs, counts, head_dim: int, width: int, order, ints,
               in_place: bool = False):
    """A run of K2's, K9's or K10's C ``entry`` as the wrapper makes it:
    the head-split inputs ``ins`` (``counts`` heads each) zero-padded a head
    to ``width``, the pointers in the entry's order (``order(ins, outs)``,
    which adds the other tensors), the integer arguments ``ints`` and, in a
    tree with the generic routes, the true ``head_dim``; the padded output
    columns are then dropped into ``outs``. At a built width (``head_dim ==
    width``), and where the tree's wrapper reads the heads in place
    (``in_place``; ``ints`` then at the true width), the entry runs on the
    tensors themselves. A tree from before the generic routes refuses a
    head_dim it was not built for."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    tail = [*ints, head_dim] if lib.generic_widths else list(ints)
    fn = getattr(lib, entry)
    if width == head_dim or in_place:
        args = [kernel_lib.ptr(t) for t in order(ins, outs)] + tail + [stream]

        def run():
            if fn(*args):
                raise RuntimeError(f"{entry} refused the launch")
        return run
    padded_outs = [torch.empty(*o.shape[:-1], counts[0] * width, dtype=o.dtype, device=o.device)
                   for o in outs]

    def run():
        if not lib.generic_widths:
            raise RuntimeError(f"{entry} predates head_dim {head_dim}")
        padded = [pad_heads(t, n, width) for t, n in zip(ins, counts)]
        if fn(*(kernel_lib.ptr(t) for t in order(padded, padded_outs)), *tail, stream):
            raise RuntimeError(f"{entry} refused the launch")
        for o, po in zip(outs, padded_outs):
            o.copy_(unpad_heads(po, counts[0], head_dim))
    return run


def k2_call(lib, b: int, s: int, heads: int, head_dim: int, gen, prepadded: bool = False):
    """(run, outputs): K2 on seeded inputs with keys padded to random
    lengths, through ``lib``'s C entry as the tree's wrapper calls it
    (heads narrower than 32 or 64 read in place where the tree's
    ``fwd_reads_in_place`` says so, else zero-padded to it in a copy).
    ``prepadded``: the kernel alone, on inputs padded once beforehand (its
    output is the padded one)."""
    q, k, v = (torch.randn(b, s, heads * head_dim, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = s
    bias = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    width = built_head_dim(head_dim, FWD_HEAD_DIMS)
    if prepadded:
        q, k, v = (pad_heads(t, heads, width) for t in (q, k, v))
    direct = prepadded or lib.fwd_in_place(head_dim, s, heads * head_dim)
    out = torch.empty_like(q)
    run = padded_run(lib, "frag_flash_attention", [q, k, v], [out], [heads] * 3, head_dim, width,
                     lambda ins, outs: (*ins, bias, *outs),
                     [b, s, q.shape[-1] if direct else heads * width, heads], direct)
    run.tensors = (q, k, v, bias)   # the run holds raw pointers into these
    return run, [out]


def k3_call(lib, n: int, h: int, plan: dict, gen, i: int = 0):
    """(run, outputs): K3 on seeded inputs at hidden h, I = i (4h by
    default), with the tree's launch ``plan`` (:func:`ffn_plan`), through
    ``lib``'s C entry."""
    p = kernel_lib.ptr
    i = i or 4 * h
    splits = plan["splits"]
    x = torch.randn(n, h, generator=gen, device="cuda").bfloat16()
    w1 = (torch.randn(h, i, generator=gen, device="cuda") * h ** -0.5).bfloat16()
    w2 = (torch.randn(i, h, generator=gen, device="cuda") * i ** -0.5).bfloat16()
    b1 = (torch.randn(i, generator=gen, device="cuda") * 0.1).bfloat16()
    b2 = (torch.randn(h, generator=gen, device="cuda") * 0.1).bfloat16()
    out = torch.empty_like(x)
    partial = torch.empty(splits, n, h, device="cuda") if splits > 1 else None
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    pp = p(partial) if partial is not None else None
    if "cols" in plan:
        scratch = torch.empty(n, i, dtype=torch.bfloat16, device="cuda")
        entry = "frag_fused_ffn_large"
        widths = (h, i) if lib.generic_widths else (i,)
        args = (p(x), p(w1), p(b1), p(w2), p(b2), p(out), p(scratch), pp, n, *widths,
                *plan["cols"], splits, stream)
    else:
        scratch = None
        entry = "frag_fused_ffn"
        args = (p(x), p(w1), p(b1), p(w2), p(b2), p(out), pp, n, h, i, splits, stream)

    def run():
        if getattr(lib, entry)(*args):
            raise RuntimeError(f"{entry} refused the launch")
    run.tensors = (x, w1, b1, w2, b2, partial, scratch)   # args holds raw pointers into these
    return run, [out]


def three_call(tensors):
    """K3's yardstick on a k3_call's inputs: ``F.linear`` -> ``F.gelu`` ->
    ``F.linear`` in bf16 (cuBLAS, the [N, I] intermediate in device
    memory), as chip_smoke.py's ThreeCallFFN."""
    import torch.nn.functional as F

    x, w1, b1, w2, b2 = tensors[:5]
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    return lambda: F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2)


def k10_call(lib, b: int, s: int, heads: int, head_dim: int, gen, padded: bool = False,
             prepadded: bool = False):
    """(run, outputs): K10 on seeded inputs, every key live or (``padded``)
    keys padded to random lengths, through ``lib``'s C entry as the tree's
    wrapper calls it (heads narrower than 32 or 64 read in place where the
    tree's ``bwd_reads_in_place`` says so, else zero-padded to it in a
    copy). ``prepadded``: the kernel alone, on inputs padded once
    beforehand (its outputs are the padded ones)."""
    q, k, v, do = (torch.randn(b, s, heads * head_dim, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    if padded:
        lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        lens[0] = s
        bias = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    width = built_head_dim(head_dim, BWD_HEAD_DIMS)
    if prepadded:
        q, k, v, do = (pad_heads(t, heads, width) for t in (q, k, v, do))
    direct = prepadded or lib.bwd_in_place(head_dim, heads * head_dim)
    outs = [torch.empty_like(q) for _ in range(3)]
    stats = torch.empty(3, b, heads, s, device="cuda")
    run = padded_run(lib, "frag_flash_attention_bwd", [q, k, v, do], outs, [heads] * 4, head_dim,
                     width, lambda ins, o: (*ins[:3], bias, ins[3], *o, stats),
                     [b, s, q.shape[-1] if direct else heads * width, heads], direct)
    run.tensors = (q, k, v, bias, do, stats)   # the run holds raw pointers into these
    return run, outs


def k9_call(lib, b: int, s: int, pads, hq: int, hkv: int, d: int, gen, dtype: str = "bf16",
            prepadded: bool = False):
    """(run, outputs): K9 on seeded inputs (bf16, or f32), through ``lib``'s
    C entry as the tree's wrapper calls it (heads narrower than 64 or 128
    read in place where the tree's ``causal_reads_in_place`` says so, else
    zero-padded to it in a copy). ``prepadded``: the kernel alone, on
    inputs padded once beforehand (its output is the padded one)."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.randn(b, s, hq * d, generator=gen, device="cuda").to(dt)
    k, v = (torch.randn(b, s, hkv * d, generator=gen, device="cuda").to(dt) for _ in range(2))
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
    width = built_head_dim(d, CAUSAL_HEAD_DIMS)
    if prepadded:
        q = pad_heads(q, hq, width)
        k, v = (pad_heads(t, hkv, width) for t in (k, v))
    direct = prepadded or lib.causal_in_place(d, hq, hkv, dt)
    out = torch.empty_like(q)
    run = padded_run(lib, "frag_causal_flash", [q, k, v], [out], [hq, hkv, hkv], d, width,
                     lambda ins, outs: (*ins, pad, *outs),
                     [b, s, hq, hkv, q.shape[-1] // hq if direct else width,
                      kernel_lib.DTYPE_CODES[q.dtype]], direct)
    run.tensors = (q, k, v, pad)   # the run holds raw pointers into these
    return run, [out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="the other tree's csrc/ directory")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--only", default=None,
                    help="comma-separated kernels to time (K1,K2,K3,K4,K5,K6,K7,K9,K10); "
                         "all by default")
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
    k3_shapes = [(label, n, h, 4 * h) for label, n, h in K3_SHAPES] + list(K3_GENERIC_SHAPES)
    ffn_plans = {(tree, n, h, i): ffn_plan(csrc, n, h, sms, i)
                 for tree, csrc in trees.items() for _, n, h, i in k3_shapes}
    # make(tree) -> (run, outputs) on that tree's library
    plans = {(tree, label): packed_plan(csrc, bq, n, sms, d)
             for tree, csrc in trees.items() for label, bq, n, d in K4_SHAPES}
    cases = [("K1", label, (b, s, dt, h), lambda tree, b=b, s=s, dt=dt, h=h: k1_call(
        libs[tree], b, s, dt, gen, h)) for label, b, s, dt, h in K1_SHAPES]
    cases += [("K4", label, {"Bq": bq, "N": n, "D": d,
                             "groups": {tree: plans[tree, label][4] for tree in trees}},
               lambda tree, label=label, bq=bq, n=n, d=d: k4_call(libs[tree], bq, n, d,
                                                                  plans[tree, label], gen))
              for label, bq, n, d in K4_SHAPES]
    k5_plans = {(tree, label): bucketed_plan(csrc, bq, n, sms,
                                             row_bytes=d * (1 if dt == "int8" else 2))
                for tree, csrc in trees.items() for label, bq, n, dt, d in K5_SHAPES}
    cases += [("K5", label, {"Bq": bq, "N": n, "dtype": dt, "D": d,
                             "groups": {tree: k5_plans[tree, label][2] for tree in trees}},
               lambda tree, label=label, bq=bq, n=n, dt=dt, d=d: k5_call(
                   libs[tree], bq, n, dt, d, k5_plans[tree, label], gen))
              for label, bq, n, dt, d in K5_SHAPES]
    k7_plans = {(tree, label): bucketed_topk_plan(csrc, bq, n, sms,
                                                  row_bytes=d * (1 if dt == "int8" else 2))
                for tree, csrc in trees.items() for label, bq, n, dt, d in K7_SHAPES}
    cases += [("K7", label, {"Bq": bq, "N": n, "dtype": dt, "D": d,
                             "groups": {tree: k7_plans[tree, label][2] for tree in trees}},
               lambda tree, label=label, bq=bq, n=n, dt=dt, d=d: k7_call(
                   libs[tree], bq, n, dt, k7_plans[tree, label], gen, d=d))
              for label, bq, n, dt, d in K7_SHAPES]
    k6_plans = {(tree, label): exact_plan(
                    csrc, bq, n, k, torch.int8 if dt == "int8" else torch.bfloat16, sms)
                for tree, csrc in trees.items() for label, bq, n, dt, k, _ in K6_SHAPES}
    cases += [("K6", label, {"Bq": bq, "N": n, "dtype": dt, "k": k, "order": order,
                             "groups": {tree: k6_plans[tree, label][2] for tree in trees}},
               lambda tree, label=label, bq=bq, n=n, dt=dt, k=k, order=order: k6_call(
                   libs[tree], bq, n, dt, k, order, k6_plans[tree, label], gen))
              for label, bq, n, dt, k, order in K6_SHAPES]
    cases += [("K2", label, (b, s, h, hd), lambda tree, b=b, s=s, h=h, hd=hd: k2_call(
        libs[tree], b, s, h, hd, gen)) for label, b, s, h, hd in K2_SHAPES + K2_GENERIC_SHAPES]
    cases += [("K2", f"{label} pre-padded", (b, s, h, hd, "kernel alone"),
               lambda tree, b=b, s=s, h=h, hd=hd: k2_call(libs[tree], b, s, h, hd, gen,
                                                          prepadded=True))
              for label, b, s, h, hd in K2_GENERIC_SHAPES]
    cases += [("K3", label, {"N": n, "H": h, "I": i,
                             "splits": {tree: ffn_plans[tree, n, h, i]["splits"] for tree in trees}},
               lambda tree, n=n, h=h, i=i: k3_call(libs[tree], n, h, ffn_plans[tree, n, h, i], gen,
                                                   i))
              for label, n, h, i in k3_shapes]
    cases += [("K10", label, (b, s, h, hd), lambda tree, b=b, s=s, h=h, hd=hd: k10_call(
        libs[tree], b, s, h, hd, gen))
        for label, b, s, h, hd in K10_SHAPES + K10_GENERIC_SHAPES + K10_TUNED_SHAPES]
    cases += [("K10", f"{label} pre-padded", (b, s, h, hd, "kernel alone"),
               lambda tree, b=b, s=s, h=h, hd=hd: k10_call(libs[tree], b, s, h, hd, gen,
                                                           prepadded=True))
              for label, b, s, h, hd in K10_GENERIC_SHAPES]
    cases += [("K10", label, (b, s, h, hd, "padded"), lambda tree, b=b, s=s, h=h, hd=hd: k10_call(
        libs[tree], b, s, h, hd, gen, padded=True)) for label, b, s, h, hd in K10_PADDED_SHAPES]
    cases += [("K9", label, (b, s, list(pads), f"{hq}/{hkv}x{d}", *dt),
               lambda tree, b=b, s=s, pads=pads, hq=hq, hkv=hkv, d=d, dt=dt: k9_call(
                   libs[tree], b, s, pads, hq, hkv, d, gen, *dt))
              for label, b, s, pads, hq, hkv, d, *dt in K9_SHAPES]
    cases += [("K9", f"{label} pre-padded", (b, s, list(pads), f"{hq}/{hkv}x{d}", *dt,
                                             "kernel alone"),
               lambda tree, b=b, s=s, pads=pads, hq=hq, hkv=hkv, d=d, dt=dt: k9_call(
                   libs[tree], b, s, pads, hq, hkv, d, gen, *dt, prepadded=True))
              for label, b, s, pads, hq, hkv, d, *dt in K9_SHAPES if label in K9_GENERIC_LABELS]
    if args.only:
        cases = [c for c in cases if c[0] in args.only.split(",")]
    for kernel, label, shape, make in cases:
        runs, outs = {}, {}
        for name in libs:
            gen.manual_seed(0)   # the same inputs for both trees
            runs[name], outs[name] = make(name)
        refused = [name for name in libs if not launches(runs[name])]
        ms, dev = {"this": [], "other": []}, {"this": [], "other": []}
        for name in ("this", "other", "other", "this"):
            if name not in refused:
                ms[name].append(cuda_ms(runs[name]))
        order = [name for name in ("this", "other", "other", "this") if name not in refused]
        fns = [runs[name] for name in order]
        if kernel == "K3":   # the yardstick, after the trees' loops
            fns.append(three_call(runs["this"].tensors))
        times = device_ms(fns)
        for name, d in zip(order, times):
            dev[name].append(d)
        row = {"kernel": kernel, "case": label, "shape": shape,
               **{f"{name}_ms": ms[name] or None for name in libs},
               **{f"{name}_dev_ms": [sum(d.values()) for d in dev[name]] or None
                  for name in libs},
               "max_rel_diff": None, "max_abs_diff": None}
        if kernel == "K3":
            row["three_call_dev_ms"] = sum(times[-1].values())
            for name in libs:   # each kernel of a call: at 1,024 the two products and the reduce
                row[f"{name}_parts_dev_ms"] = [
                    {k.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]: t
                     for k, t in d.items()} for d in dev[name]]
        if refused:
            row["refused"] = refused
        else:
            # the two trees' outputs on the same inputs: largest difference,
            # and as a share of the other tree's largest value
            diffs = [(a.float() - b.float()).abs().max().item()
                     for a, b in zip(outs["this"], outs["other"])]
            row["max_rel_diff"] = max(d / b.float().abs().max().item()
                                      for d, b in zip(diffs, outs["other"]))
            row["max_abs_diff"] = max(diffs)
        if kernel in SWEEP_PARTS:
            for name in ("this", "other"):
                for part, key in zip(("sweep", "merge"), SWEEP_PARTS[kernel]):
                    row[f"{name}_{part}_dev_ms"] = [
                        sum(t for kname, t in d.items() if key in kname) for d in dev[name]]
                if kernel == "K7":   # the rest of its device time is the sort's
                    row[f"{name}_sort_dev_ms"] = [
                        sum(t for kname, t in d.items()
                            if not any(key in kname for key in SWEEP_PARTS[kernel]))
                        for d in dev[name]]
        rows.append(row)
    line = {"card": smi, "order": "this, other, other, this", "rows": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(line, indent=1))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
