#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (financial_rag_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--log-dir DIR]

Phases, each printing one JSON line:

1. device  -- CUDA must be available; the card's name and power limit, as
              ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
              prints them, go on a line of their own.
2. build   -- the CUDA kernel library is built from csrc/ (one nvcc per
              source, in parallel).
3. kernel  -- every kernel of the served path at its main-path shapes,
              against its plain PyTorch version on the same inputs, with its
              time, the plain version's, the library call's where one PyTorch
              call computes the same function, and its bound (the larger of
              bytes at 3.35 TB/s and operations at the peak rate of their
              type).
4. slice   -- full-width seeded random checkpoints (bge-small, gte-small,
              MiniLM-L-6 cross-encoder) are written to a temporary data dir;
              Runtime.build(device="cuda") ingests a seeded Marker-JSON
              corpus of >= 2,048 children and answers the 9 golden questions
              through RAGEngine.query. Every launch counter is set to 0 just
              before and read just after: each kernel must have run.
5. profile -- the golden questions, reworded past the caches, once more
              under torch.profiler: device busy and idle share, device time
              by kernel, and the package's host spans.
6. parity  -- 16 corpus texts through the same weights on the CPU (plain
              versions, f32) against the card's bf16 embeddings and logits.
7. the ``kernels`` line, then the last line ``{"ok": true, "device": ...}``.

Exits non-zero (and prints no result line) on any failure, when CUDA is not
available, or when the port's package is not beside this file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}

GOLDEN_CORPUS = {
    "lease_2022": (
        "LEASE DEED executed between M/s Bhartiya Enterprises (the Lessor) and "
        "Acme Trading Pvt Ltd (the Lessee). The monthly rent for the first year "
        "shall be Rs 40,000. The monthly rent for the second year shall be "
        "Rs 42,800. The lock-in period under this lease is 36 months from the "
        "commencement date of 1 April 2022. A security deposit of Rs 2,40,000 "
        "is payable on signing. " * 2
    ),
    "invoice_cn24": (
        "TAX INVOICE / CREDIT NOTE No. CN/24 dated 30-Jul-22 issued by Bhartiya "
        "Enterprises, Chakulia. Taxable value Rs 2,15,625. CGST at 9 percent: "
        "Rs 19,406.25. SGST at 9 percent: Rs 19,406.25. Total invoice amount "
        "Rs 2,54,434 rounded. GSTIN 20AAIPL4886F1ZQ. " * 2
    ),
    "salary_memo": (
        "INTERNAL MEMO: the annual appraisal cycle concludes in March. Salary "
        "revisions take effect from 1 April. The travel reimbursement cap is "
        "Rs 3,500 per trip for domestic travel and requires manager approval. " * 3
    ),
    "insurance_policy": (
        "FIRE INSURANCE POLICY No. FI-9981 covering the warehouse at Chakulia. "
        "The sum insured is Rs 75,00,000. The annual premium is Rs 82,500 "
        "payable before 15 June each year. The policy excludes flood damage. " * 2
    ),
    "utility_bills": (
        "ELECTRICITY STATEMENT for March: units consumed 12,480, amount payable "
        "Rs 1,12,320 by the due date of 21 April. Late payment surcharge is 1.5 "
        "percent per month. Meter number JH-40213. " * 3
    ),
}

GOLDEN_QUESTIONS = [
    "What is the rent for the second year?",
    "What is the lock-in period of the lease?",
    "Who is the lessor?",
    "What is the total invoice amount on the credit note?",
    "What is the CGST amount?",
    "What is the sum insured under the fire policy?",
    "What is the annual premium for the insurance?",
    "What is the travel reimbursement cap per trip?",
    "How many electricity units were consumed in March?",
]

FILLER_WORDS = (
    "invoice ledger payment vendor supplier lessee lessor premium policy clause "
    "quarter annual monthly audit statement balance credit debit tax GST CGST SGST "
    "deposit warehouse insurance claim schedule amount payable receivable revenue "
    "expense capital depreciation asset liability equity dividend interest loan "
    "principal maturity contract renewal termination notice period approval manager "
    "director board resolution compliance filing return assessment refund surcharge "
    "rebate discount freight shipment consignment purchase order delivery challan "
    "account bank transfer cheque cash voucher receipt memo circular agreement"
).split()

MIN_CHILDREN = 2048
# normalization_method values that only a cross-encoder score produces
CROSS_ENCODER_METHODS = ("max-normalization", "min-max-normalization", "rank-based")

# the Pallas kernel each CUDA kernel replaces, and its source in the port
KERNELS = {
    "masked_mean_l2_normalize": ("financial_rag_tpu_torch/csrc/pool_norm.cu",
                                 "financial_rag_tpu/ops/pool_norm.py:19"),
    "flash_attention": ("financial_rag_tpu_torch/csrc/flash_attention.cu",
                        "financial_rag_tpu/ops/flash_attention.py:28"),
    "fused_ffn": ("financial_rag_tpu_torch/csrc/fused_ffn.cu",
                  "financial_rag_tpu/ops/fused_ffn.py:24"),
    "packed_topk_fused": ("financial_rag_tpu_torch/csrc/packed_topk.cu",
                          "financial_rag_tpu/ops/topk.py:297"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ timing

def cuda_ms(torch, fn, budget_ms: float = 300.0) -> float:
    """Mean device time of fn() over a run of launches, by CUDA events,
    after a warm-up; the run is long enough to fill ~budget_ms."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max(budget_ms / once, 3), 200))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, op_type: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases

def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card,
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build(kernel_lib, log_dir):
    t0 = time.perf_counter()
    path = kernel_lib.build()
    kernel_lib.load()
    seconds = time.perf_counter() - t0
    log = kernel_lib.BUILD_INFO.get("log")
    if log_dir and log:
        shutil.copy(log, Path(log_dir) / "kernel_build.log")
    emit({"phase": "build", "seconds": round(seconds, 3), "library": str(path)})


def kernel_cases(torch, F, seed):
    """(name, shape label, run kernel, run plain, run library or None,
    compare(kernel_out, plain_out) -> (max_abs_err, ok, detail), bound)."""
    from financial_rag_tpu_torch.ops import flash_attention as fa
    from financial_rag_tpu_torch.ops import fused_ffn as ffn
    from financial_rag_tpu_torch.ops import pool_norm as pn
    from financial_rag_tpu_torch.ops import topk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf16 = torch.bfloat16
    H, NH, I = 384, 12, 1536

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def padded_mask(b, s, fully_masked_row=False):
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
        lens[0] = s
        mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        if fully_masked_row:
            mask[-1] = 0
        return mask

    def max_abs(tol):
        def cmp(a, b):
            err = (a.float() - b.float()).abs().max().item()
            return err, err <= tol, {"tol": tol}
        return cmp

    cases = []
    for b, s in ((256, 512), (8, 64)):
        hidden = randn(b, s, H, dtype=bf16)
        mask = padded_mask(b, s)
        live = int(mask.sum().item())
        cases.append(("masked_mean_l2_normalize", f"B={b},S={s},H={H},bf16",
                      lambda h=hidden, m=mask: pn.masked_mean_l2_normalize(h, m),
                      lambda h=hidden, m=mask: pn.masked_mean_l2_normalize_plain(h, m),
                      None, max_abs(1e-5),
                      bound(live * H * 2 + b * s * 4 + b * H * 4, 2 * live * H, "f32")))

    for b, s in ((256, 512), (8, 64), (32, 256)):
        q, k, v = (randn(b, s, H, dtype=bf16) for _ in range(3))
        mask = padded_mask(b, s, fully_masked_row=(b == 8))
        bias = torch.where(mask > 0, 0.0, -1e9).float()
        hd = H // NH

        def sdpa(q=q, k=k, v=v, bias=bias, b=b, s=s):
            split = lambda x: x.view(b, s, NH, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(
                split(q), split(k), split(v), attn_mask=bias.to(bf16)[:, None, None, :])

        cases.append(("flash_attention", f"B={b},S={s},H={H},heads={NH},bf16",
                      lambda q=q, k=k, v=v, bias=bias: fa.flash_attention(q, k, v, bias, num_heads=NH),
                      lambda q=q, k=k, v=v, bias=bias: fa.flash_attention_plain(q, k, v, bias, num_heads=NH),
                      sdpa, max_abs(3e-2),
                      bound(4 * b * s * H * 2 + b * s * 4, 4 * b * NH * s * s * hd, "bf16")))

    w1, w2 = randn(H, I, dtype=bf16, scale=H ** -0.5), randn(I, H, dtype=bf16, scale=0.012)
    b1, b2 = randn(I, dtype=bf16, scale=0.1), randn(H, dtype=bf16, scale=0.1)
    for b, s in ((256, 512), (8, 64)):
        x = randn(b, s, H, dtype=bf16)
        n = b * s
        cases.append(("fused_ffn", f"N={n} (B={b},S={s}),H={H},I={I},bf16",
                      lambda x=x: ffn.fused_ffn(x, w1, b1, w2, b2),
                      lambda x=x: ffn.fused_ffn_plain(x, w1, b1, w2, b2),
                      None, max_abs(3e-2),
                      bound(2 * n * H * 2 + (2 * H * I + I + H) * 2, 4 * n * H * I, "bf16")))

    def topk_cmp(bits, exact=False):
        quantum = 2.0 ** (bits - 22)

        def cmp(a, b):
            (ks, ki), (ps, pi) = a, b
            same = (ki == pi)
            frac = same.float().mean().item()
            diff = (ks - ps).abs()
            err = diff.max().item()
            worst_differing = diff[~same].max().item() if (~same).any() else 0.0
            if exact:
                ok = frac == 1.0 and err == 0.0
            else:
                ok = frac >= 0.99 and worst_differing <= quantum + 1e-3
            return err, ok, {"ids_identical": frac, "worst_differing_pair": worst_differing,
                             "quantum": quantum}
        return cmp

    bq, d, k = 128, H, 24
    for n, dtype, label in ((102400, bf16, "bf16"), (16384, bf16, "bf16"),
                            (16384, torch.float32, "f32")):
        x = randn(n, d)
        x = (x / x.norm(dim=1, keepdim=True)).to(dtype)
        queries = randn(bq, d)
        queries = queries / queries.norm(dim=1, keepdim=True)
        valid = (torch.rand(n, generator=gen, device=dev) > 0.03).float()
        ntiles = n // 1024
        bits = max((ntiles - 1).bit_length(), 1)
        esize = 2 if dtype == bf16 else 4
        cases.append(("packed_topk_fused", f"Bq={bq},N={n},D={d},k={k},{label}",
                      lambda q=queries, x=x, v=valid: topk.packed_topk_fused(q, x, v, k),
                      lambda q=queries, x=x, v=valid: topk.packed_topk_fused_plain(q, x, v, k),
                      None, topk_cmp(bits),
                      bound(n * d * esize + n * 4 + bq * d * 4 + bq * k * 8, 2 * bq * n * d,
                            "bf16" if dtype == bf16 else "f32")))

    # exact-grid data with repeated rows: every score and tie is exact, so the
    # kernel must reproduce the plain version (the packing and tie rules) bit for bit
    n = 16384
    x = (torch.randint(-3, 4, (n, d), generator=gen, device=dev).float() / 64.0)
    x[4096:8192] = x[:4096]
    x = x.to(bf16)
    queries = torch.randint(-3, 4, (bq, d), generator=gen, device=dev).float() / 64.0
    valid = (torch.rand(n, generator=gen, device=dev) > 0.1).float()
    cases.append(("packed_topk_fused", f"Bq={bq},N={n},D={d},k={k},bf16,exact-grid+ties",
                  lambda: topk.packed_topk_fused(queries, x, valid, k),
                  lambda: topk.packed_topk_fused_plain(queries, x, valid, k),
                  None, topk_cmp(4, exact=True),
                  bound(n * d * 2 + n * 4 + bq * d * 4 + bq * k * 8, 2 * bq * n * d, "bf16")))
    return cases


def phase_kernels(torch, F, seed):
    """Returns {kernel name: the entry of its largest main-path shape}."""
    results = {}
    failures = []
    for name, shape, run, plain, library, cmp, (bound_ms, bound_by) in kernel_cases(torch, F, seed):
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        err, ok, detail = cmp(out, ref)
        ms = cuda_ms(torch, run)
        plain_ms = cuda_ms(torch, plain)
        lib_ms = cuda_ms(torch, library) if library is not None else None
        if library is not None:
            lib_err = (library().transpose(1, 2).reshape(out.shape).float() - out.float()
                       ).abs().max().item()
            detail["library_max_abs_err"] = lib_err
        entry = {"phase": "kernel", "name": name, "shape": shape, "max_abs_err": err, "ok": ok,
                 "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, **detail}
        emit(entry)
        if not ok:
            failures.append(f"{name} [{shape}]: {detail} max_abs_err={err}")
        if name not in results:       # the first case of each kernel is its largest shape
            results[name] = entry
        else:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        del out, ref
        torch.cuda.empty_cache()
    check(not failures, "kernel mismatch: " + "; ".join(failures))
    return results


def write_checkpoints(root: Path, seed: int):
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params, save_params_npz

    base = {"hidden_size": 384, "num_attention_heads": 12, "intermediate_size": 1536,
            "vocab_size": 30522, "max_position_embeddings": 512, "type_vocab_size": 2,
            "layer_norm_eps": 1e-12}
    specs = {
        "bge-small": ({**base, "num_hidden_layers": 12, "architectures": ["BertModel"]}, 0),
        "gte-small": ({**base, "num_hidden_layers": 12, "architectures": ["BertModel"]}, 0),
        "minilm-l6-ce": ({**base, "num_hidden_layers": 6,
                          "architectures": ["BertForSequenceClassification"],
                          "id2label": {"0": "LABEL_0"}}, 1),
    }
    paths = {}
    for i, (name, (raw, labels)) in enumerate(specs.items()):
        d = root / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(raw))   # no vocab.txt: the vendored vocab
        cfg = ModelConfig.from_json(d)
        check(cfg.num_labels == labels and cfg.hidden_size == 384, f"config of {name}")
        save_params_npz(random_params(cfg, seed=seed + i), d / "model.npz")
        paths[name] = d
    return paths


def filler_documents(rng, n_docs: int, words_per_doc: int):
    docs = {}
    for i in range(n_docs):
        blocks, words, page = [], 0, 0
        while words < words_per_doc:
            sents = []
            for _ in range(int(rng.integers(3, 7))):
                n = int(rng.integers(8, 20))
                toks = [FILLER_WORDS[j] for j in rng.integers(0, len(FILLER_WORDS), n)]
                toks[int(rng.integers(0, n))] = f"Rs {int(rng.integers(100, 10**7)):,}"
                sents.append(" ".join(toks).capitalize() + ".")
                words += n + 1
            blocks.append({"content": " ".join(sents), "page": page})
            page += int(rng.random() < 0.2)
        docs[f"filler_{i:03d}"] = {"blocks": blocks}
    return docs


def phase_slice(torch, seed, work: Path):
    import numpy as np

    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.models.encoder import Encoder
    from financial_rag_tpu_torch.ops import flash_attention as fa
    from financial_rag_tpu_torch.ops import fused_ffn as ffn
    from financial_rag_tpu_torch.ops import pool_norm as pn
    from financial_rag_tpu_torch.ops import topk
    from financial_rag_tpu_torch.runtime import Runtime

    t0 = time.perf_counter()
    paths = write_checkpoints(work / "models", seed)
    os.environ["EMBED_BAAI_PATH"] = str(paths["bge-small"])
    os.environ["EMBED_GTE_PATH"] = str(paths["gte-small"])
    os.environ["CROSS_ENCODER_PATH"] = str(paths["minilm-l6-ce"])
    cfg = FrameworkConfig.from_env()
    cfg.llm.gemini_api_key = None              # NullLLM: no network
    checkpoints_s = time.perf_counter() - t0

    src = work / "extracted"
    src.mkdir()
    rng = np.random.default_rng(seed)
    docs = {doc_id: {"blocks": [{"content": text, "page": 0}]}
            for doc_id, text in GOLDEN_CORPUS.items()}
    docs.update(filler_documents(rng, n_docs=22, words_per_doc=15000))
    items = []
    for doc_id, doc in docs.items():
        f = src / f"{doc_id}.json"
        f.write_text(json.dumps(doc))
        items.append((f, doc_id))

    counters = {"masked_mean_l2_normalize": pn, "flash_attention": fa, "fused_ffn": ffn,
                "packed_topk_fused": topk}
    for mod in counters.values():
        mod.LAUNCHES = 0

    t_build = time.perf_counter()
    rt = Runtime.build(cfg, data_dir=work / "data", device="cuda")
    build_s = time.perf_counter() - t_build
    check(all(isinstance(e, Encoder) for e in rt.dual_encoder.encoders.values()),
          "an encoder fell back to the lexical HashingEncoder")
    check(rt.engine.reranker.model is not None, "the cross-encoder did not load")
    check(all(i.backend == "pallas_fused" for i in rt.indexes.values()),
          "an index is not on the packed sweep")

    t_ingest = time.perf_counter()
    results = rt.pipeline.ingest_paths(items)
    rt.pipeline.flush()
    ingest_s = time.perf_counter() - t_ingest
    errors = [r for r in results if r is None or "error" in r]
    check(not errors, f"ingest errors: {errors[:3]}")
    children = sum(r["children"] for r in results)
    check(children >= MIN_CHILDREN, f"only {children} children ingested")
    check(all(i.count() == children for i in rt.indexes.values()), "index counts differ")
    ingest_launches = {name: mod.LAUNCHES for name, mod in counters.items()}

    methods = []
    rerank = rt.engine.reranker.rerank_chunks

    def recording_rerank(*a, **kw):
        out = rerank(*a, **kw)
        methods.extend(c.get("normalization_method") for c in out)
        return out

    rt.engine.reranker.rerank_chunks = recording_rerank
    query_ms, answers = [], []
    for question in GOLDEN_QUESTIONS:
        tq = time.perf_counter()
        out = rt.engine.query(question)
        query_ms.append((time.perf_counter() - tq) * 1e3)
        check(out.get("success") is True, f"query failed: {question!r}: {out.get('answer')}")
        check(out["top_children_chunks"], f"no children for {question!r}")
        answers.append(out)
    check("fallback-uniform" not in methods, "the rerank fell back to uniform scores")
    check(any(m in CROSS_ENCODER_METHODS for m in methods), "no query reached the cross-encoder")
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    query_launches = {name: launches[name] - ingest_launches[name] for name in launches}
    check(all(v > 0 for v in query_launches.values()),
          f"a kernel never launched on the query path: {query_launches}")

    emit({"phase": "slice", "children": children, "documents": len(items),
          "index_capacity": rt.indexes["baai"].capacity,
          "checkpoints_s": round(checkpoints_s, 3), "runtime_build_s": round(build_s, 3),
          "ingest_s": round(ingest_s, 3), "children_per_s": round(children / ingest_s, 1),
          "query_p50_ms": round(statistics.median(query_ms), 3),
          "query_max_ms": round(max(query_ms), 3), "queries": len(query_ms),
          "reranked_methods": sorted({str(m) for m in methods}),
          "launches": launches, "launches_ingest": ingest_launches,
          "launches_queries": query_launches})
    texts = [c["text"] for out in answers for c in out["top_children_chunks"]]
    return rt, paths, launches, texts


def _kernel_family(name: str) -> str:
    for family, needles in (("port kernels", ("attn_fwd_kernel", "ffn_fwd_kernel",
                                              "packed_sweep_kernel", "packed_merge_kernel",
                                              "pool_norm_kernel")),
                            ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
                            ("copy", ("Memcpy", "Memset", "copy_"))):
        if any(n in name for n in needles):
            return family
    return "other"


def phase_profile(torch, rt):
    """Where one query's time goes: the golden questions, reworded so that
    neither the result cache nor the query-embedding cache answers them, run
    once more under torch.profiler. Device busy time is the sum of the
    kernels' and copies' own device time; the rest of the wall clock the
    card sat idle. The host spans are the package's own time_block labels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from financial_rag_tpu_torch.utils.timing import GLOBAL_TIMER

    questions = [f"Tell me briefly: {q}" for q in GOLDEN_QUESTIONS]
    torch.cuda.synchronize()
    GLOBAL_TIMER.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in questions:
            check(rt.engine.query(q).get("success") is True, f"profiled query failed: {q!r}")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = GLOBAL_TIMER.summary()
    # the device's own activities (kernels, copies); the time_block ranges
    # also appear on the device timeline and would count their gaps as busy
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in spans]
    by_name: dict = {}
    families: dict = {}
    for e in acts:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        total, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + ms, calls + 1)
        families[_kernel_family(e.name)] = families.get(_kernel_family(e.name), 0.0) + ms
    busy_us, reach = 0.0, float("-inf")   # union of the activities' intervals
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in acts):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3
    check(busy_ms > 0, "the profiler saw no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "profile", "queries": len(questions), "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
          "device_ms_by_family": families,
          "top_device_ms": [{"name": n[:90], "ms": ms, "calls": c} for n, (ms, c) in top],
          "host_span_ms": {k: v["total_s"] * 1e3 for k, v in list(spans.items())[:14]}})


def phase_parity(torch, rt, paths, texts):
    """The same weights through the port on the CPU (plain versions, f32)."""
    import numpy as np

    from financial_rag_tpu_torch.models.encoder import Encoder
    from financial_rag_tpu_torch.retrieval.rerank import CrossEncoderModel

    torch.set_num_threads(max(os.cpu_count() or 1, 1))
    seen, sample = set(), []
    for t in texts:
        if t not in seen:
            seen.add(t)
            sample.append(t)
    sample = sample[:16]
    check(len(sample) == 16, "fewer than 16 distinct corpus texts")
    out = {"phase": "parity", "texts": len(sample)}
    for name, path, pooling in (("baai", paths["bge-small"], "cls"),
                                ("gte", paths["gte-small"], "mean")):
        gpu = rt.dual_encoder.encoders[name].encode(sample)
        cpu = Encoder.from_pretrained(str(path), pooling=pooling, device="cpu").encode(sample)
        cos = (gpu * cpu).sum(1) / (np.linalg.norm(gpu, axis=1) * np.linalg.norm(cpu, axis=1))
        out[f"{name}_min_cos"] = float(cos.min())
        check(cos.min() >= 0.999, f"{name} embeddings: min cosine {cos.min()}")
    pairs = [(GOLDEN_QUESTIONS[i % len(GOLDEN_QUESTIONS)], t) for i, t in enumerate(sample)]
    gpu = rt.engine.reranker.model.predict(pairs)
    cpu = CrossEncoderModel.from_pretrained(str(paths["minilm-l6-ce"]), device="cpu").predict(pairs)
    err = float(np.abs(gpu - cpu).max())
    out["cross_encoder_max_abs_err"] = err
    out["cross_encoder_logit_range"] = [float(cpu.min()), float(cpu.max())]
    check(err <= 5e-2, f"cross-encoder logits differ by {err}")
    emit(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None,
                    help="also write the kernel build log and the kernels line here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one "
              "CUDA GPU", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "financial_rag_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: financial_rag_tpu_torch not found beside {__file__}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(here))
    import torch.nn.functional as F

    from financial_rag_tpu_torch.ops import kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    log_dir = args.log_dir
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
    try:
        info = phase_device(torch)
        phase_build(kernel_lib, log_dir)
        timings = phase_kernels(torch, F, args.seed)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            rt, paths, launches, texts = phase_slice(torch, args.seed, Path(tmp))
            phase_profile(torch, rt)
            phase_parity(torch, rt, paths, texts)
    except Exception:  # noqa: BLE001 -- any failure ends the run non-zero
        traceback.print_exc()
        return 1

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": t["max_abs_err"],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "shape": t["shape"]})
    line = {"kernels": kernels}
    if log_dir:
        (Path(log_dir) / "kernels.json").write_text(json.dumps(line, indent=1))
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
