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
with every key live and with padded keys; K9 also at
heads of 128, Qwen2-1.5B's, Qwen2-7B's and Llama-3-8B's), the two libraries in
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
both trees, but what a launch plan puts in them is each tree's own: K3 gets
from each tree's ``ops/fused_ffn.py`` (beside its ``csrc/``) the split of
the I axis its wrapper would choose (its ``launch_plan``), and scratch of
that many f32 partials;
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
             ("wide tp4 local", 64, 128, 3, 64))
# (label, N, H) of K3 with I = 4H: at H=384 the table's shape, the training
# encode and a query's 8 x 64 tokens; at H=768 (bge-base) the table's shape,
# the wide ingest's batch (68 x 512) and a query's
K3_SHAPES = (("K3 table", 131072, 384), ("train encode", 32768, 384), ("query", 512, 384),
             ("wide table", 131072, 768), ("wide ingest", 34816, 768), ("wide query", 512, 768))
# (label, B, S, dtype) of K1 at H=384: the table's shape, the ingest's
# batches (3,482 children in 51 launches), a query's encode, and f32
K1_SHAPES = (("K1 table", 256, 512, "bf16"), ("ingest", 68, 512, "bf16"),
             ("ingest short", 68, 128, "bf16"), ("query", 8, 64, "bf16"),
             ("f32", 64, 512, "f32"))
# (label, Bq, N, D) of K4 at k=24, bf16: at D=384 the table's shape, a query
# batch over the same corpus, the served shape (one query per launch over
# the smoke test's index capacity), a smaller corpus, and one tile (bits 1);
# at D=768 the table's shape, the batch of 8 and the batcher's wave of 192
K4_SHAPES = (("K4 table", 128, 102400, 384), ("batch of 8", 8, 102400, 384),
             ("served", 1, 4096, 384), ("N=16,384", 128, 16384, 384), ("one tile", 128, 1024, 384),
             ("D=768 table", 128, 102400, 768), ("D=768 batch of 8", 8, 102400, 768),
             ("D=768 wave", 192, 4096, 768))
# (label, Bq, N, dtype, D) of K5 at k=24, 4,096 buckets: at D=384 int8 (the
# int8 index's sweep) at the table's shape, a query batch and the served
# shape (one query per launch over the smoke test's index capacity), and
# bf16 at the table's; at D=768 the table's and the served shape, int8 and
# bf16
K5_SHAPES = (("K5 table", 128, 102400, "int8", 384), ("batch of 8", 8, 102400, "int8", 384),
             ("served", 1, 4096, "int8", 384), ("bf16 table", 128, 102400, "bf16", 384),
             ("D=768 table", 128, 102400, "int8", 768), ("D=768 served", 1, 4096, "int8", 768),
             ("D=768 bf16 table", 128, 102400, "bf16", 768),
             ("D=768 bf16 served", 1, 4096, "bf16", 768))
# (label, Bq, N, dtype) of K7 at D=384, k=24, 4,096 buckets (backend
# pallas_bucketed): the table's shape in bf16 and int8, and the backends
# phase's 9 questions over the index capacity
K7_SHAPES = (("K7 table", 128, 102400, "bf16"), ("int8 table", 128, 102400, "int8"),
             ("backends", 9, 4096, "bf16"))
# (label, Bq, N, dtype, k, order) of K6 at D=384: the table's shape, int8 at
# N=16,384, the backends phase's 9 questions over the index capacity, k=128,
# and a corpus whose every row outscores the one before (every key passes
# the filter)
K6_SHAPES = (("K6 table", 128, 102400, "bf16", 24, "grid"),
             ("int8 N=16,384", 128, 16384, "int8", 24, "grid"),
             ("backends", 9, 4096, "bf16", 24, "grid"),
             ("k=128", 128, 102400, "bf16", 128, "grid"),
             ("ascending", 128, 16384, "bf16", 24, "ascending"))
# (label, B, S, pads, query heads, kv heads, head_dim) of K9: at the
# Qwen2-0.5B head shape (14 / 2 heads of 64), then at heads of 128 (Qwen2-1.5B's
# 12 / 2 at the served answer prompt and at pad 0, Qwen2-7B's 28 / 4,
# Llama-3-8B's 32 / 8)
K9_SHAPES = (("answer prompt", 1, 4096, (1100,), 14, 2, 64), ("normaliser", 1, 128, (60,), 14, 2, 64),
             ("generate_many", 3, 1024, (0, 300, 1023), 14, 2, 64),
             ("Qwen2-1.5B answer prompt", 1, 4096, (1100,), 12, 2, 128),
             ("Qwen2-1.5B pad 0", 1, 4096, (0,), 12, 2, 128),
             ("Qwen2-7B pad 0", 1, 4096, (0,), 28, 4, 128),
             ("Llama-3-8B pad 0", 1, 4096, (0,), 32, 8, 128))


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
    for name in ("frag_pool_norm", "frag_flash_attention", "frag_fused_ffn", "frag_packed_topk",
                 "frag_bucketed_topk", "frag_topk_exact", "frag_flash_attention_bwd",
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


def ffn_splits(csrc: Path, n: int, h: int, sms: int) -> int:
    """The I-axis split the wrapper beside ``csrc`` (its ``ops/fused_ffn.py``)
    chooses for n tokens at hidden h, I = 4h: each tree's kernel is given
    the split it was tuned for (a tree before the 768 design has no
    ``launch_plan`` and only the 384 rule)."""
    mod = tree_module(csrc, "fused_ffn")
    if hasattr(mod, "launch_plan"):
        return mod.launch_plan(n, h, 4 * h, sms)[2]
    return mod.split_count(-(-n // mod.KERNEL_TOKENS), 4 * h // mod.KERNEL_CHUNK, sms)


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


def bucketed_topk_plan(csrc: Path, bq: int, n: int, sms: int, nbuckets: int = 4096):
    """(Bqp, rounds_per_group, groups) that K7's wrapper beside ``csrc``
    chooses for Bq queries over N int8 or bf16 rows."""
    mod = tree_module(csrc, "topk")
    if hasattr(mod, "bucketed_launch_plan"):
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


def k7_call(lib, bq: int, n: int, dtype: str, plan, gen, k: int = 24, nbuckets: int = 4096):
    """(run, outputs): K7 on exact-grid data (``sweep_inputs``) with scratch
    as ``plan`` says, through ``lib``'s C entry, then the wrapper's stable
    top k of the [Bq, nbuckets] maxima; the outputs are the maxima."""
    from financial_rag_tpu_torch.ops import topk

    p = kernel_lib.ptr
    bqp, per_group, groups = plan
    q, x, valid = sweep_inputs(bq, bqp, n, dtype, gen)
    keys = torch.empty(groups, bqp, nbuckets, dtype=torch.int64, device="cuda")
    out_s = torch.empty(bq, nbuckets, device="cuda")
    out_i = torch.empty(bq, nbuckets, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(x), p(valid), p(keys), p(out_s), p(out_i), bq, bqp, n, 384, nbuckets, 0,
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


def k2_call(lib, b: int, s: int, heads: int, head_dim: int, gen):
    """(run, outputs): K2 on seeded inputs with keys padded to random
    lengths, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    q, k, v = (torch.randn(b, s, heads * head_dim, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = s
    bias = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(k), p(v), p(bias), p(out), b, s, heads * head_dim, heads, stream)

    def run():
        if lib.frag_flash_attention(*args):
            raise RuntimeError("frag_flash_attention refused the launch")
    run.tensors = (q, k, v, bias)   # args holds raw pointers into these
    return run, [out]


def k3_call(lib, n: int, h: int, splits: int, gen):
    """(run, outputs): K3 on seeded inputs at hidden h, I = 4h, with
    ``splits`` blocks per token tile, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    i = 4 * h
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


def k10_call(lib, b: int, s: int, heads: int, head_dim: int, gen, padded: bool = False):
    """(run, outputs): K10 on seeded inputs, every key live or (``padded``)
    keys padded to random lengths, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    q, k, v, do = (torch.randn(b, s, heads * head_dim, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    if padded:
        lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        lens[0] = s
        bias = torch.where(torch.arange(s, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    outs = [torch.empty_like(q) for _ in range(3)]
    stats = torch.empty(3, b, heads, s, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (*(p(t) for t in (q, k, v, bias, do, *outs, stats)), b, s, heads * head_dim, heads,
            stream)

    def run():
        if lib.frag_flash_attention_bwd(*args):
            raise RuntimeError("frag_flash_attention_bwd refused the launch")
    run.tensors = (q, k, v, bias, do, stats)   # args holds raw pointers into these
    return run, outs


def k9_call(lib, b: int, s: int, pads, hq: int, hkv: int, d: int, gen):
    """(run, outputs): K9 on seeded inputs, through ``lib``'s C entry."""
    p = kernel_lib.ptr
    q = torch.randn(b, s, hq * d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s, hkv * d, generator=gen, device="cuda").bfloat16() for _ in range(2))
    pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    args = (p(q), p(k), p(v), p(pad), p(out), b, s, hq, hkv, d, kernel_lib.DTYPE_CODES[q.dtype],
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
    splits = {(tree, n, h): ffn_splits(csrc, n, h, sms)
              for tree, csrc in trees.items() for _, n, h in K3_SHAPES}
    # make(tree) -> (run, outputs) on that tree's library
    plans = {(tree, label): packed_plan(csrc, bq, n, sms, d)
             for tree, csrc in trees.items() for label, bq, n, d in K4_SHAPES}
    cases = [("K1", label, (b, s, dt), lambda tree, b=b, s=s, dt=dt: k1_call(libs[tree], b, s, dt, gen))
             for label, b, s, dt in K1_SHAPES]
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
    k7_plans = {(tree, bq, n): bucketed_topk_plan(csrc, bq, n, sms)
                for tree, csrc in trees.items() for _, bq, n, _ in K7_SHAPES}
    cases += [("K7", label, {"Bq": bq, "N": n, "dtype": dt,
                             "groups": {tree: k7_plans[tree, bq, n][2] for tree in trees}},
               lambda tree, bq=bq, n=n, dt=dt: k7_call(libs[tree], bq, n, dt,
                                                       k7_plans[tree, bq, n], gen))
              for label, bq, n, dt in K7_SHAPES]
    k6_plans = {(tree, label): exact_plan(
                    csrc, bq, n, k, torch.int8 if dt == "int8" else torch.bfloat16, sms)
                for tree, csrc in trees.items() for label, bq, n, dt, k, _ in K6_SHAPES}
    cases += [("K6", label, {"Bq": bq, "N": n, "dtype": dt, "k": k, "order": order,
                             "groups": {tree: k6_plans[tree, label][2] for tree in trees}},
               lambda tree, label=label, bq=bq, n=n, dt=dt, k=k, order=order: k6_call(
                   libs[tree], bq, n, dt, k, order, k6_plans[tree, label], gen))
              for label, bq, n, dt, k, order in K6_SHAPES]
    cases += [("K2", label, (b, s, h, hd), lambda tree, b=b, s=s, h=h, hd=hd: k2_call(
        libs[tree], b, s, h, hd, gen)) for label, b, s, h, hd in K2_SHAPES]
    cases += [("K3", label, {"N": n, "H": h, "splits": {tree: splits[tree, n, h] for tree in trees}},
               lambda tree, n=n, h=h: k3_call(libs[tree], n, h, splits[tree, n, h], gen))
              for label, n, h in K3_SHAPES]
    cases += [("K10", label, (b, s, h, hd), lambda tree, b=b, s=s, h=h, hd=hd: k10_call(
        libs[tree], b, s, h, hd, gen)) for label, b, s, h, hd in K10_SHAPES]
    cases += [("K10", label, (b, s, h, hd, "padded"), lambda tree, b=b, s=s, h=h, hd=hd: k10_call(
        libs[tree], b, s, h, hd, gen, padded=True)) for label, b, s, h, hd in K10_PADDED_SHAPES]
    cases += [("K9", label, (b, s, list(pads), f"{hq}/{hkv}x{d}"),
               lambda tree, b=b, s=s, pads=pads, hq=hq, hkv=hkv, d=d: k9_call(
                   libs[tree], b, s, pads, hq, hkv, d, gen))
              for label, b, s, pads, hq, hkv, d in K9_SHAPES]
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
        for name in ("this", "other", "other", "this"):
            if name not in refused:
                dev[name].append(device_ms(runs[name]))
        row = {"kernel": kernel, "case": label, "shape": shape,
               **{f"{name}_ms": ms[name] or None for name in libs},
               **{f"{name}_dev_ms": [sum(d.values()) for d in dev[name]] or None
                  for name in libs},
               "max_rel_diff": None, "max_abs_diff": None}
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
