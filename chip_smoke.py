#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (financial_rag_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--log-dir DIR]

Phases, each printing one JSON line:

1. device  -- CUDA must be available; the card's name and power limit, as
              ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
              prints them, go on a line of their own.
2. build   -- the CUDA kernel library is built from csrc/ (one nvcc per
              source, in parallel); for each kernel of the wgmma sources
              (K2-K6, K9, K10) its registers, shared memory and spills
              (ptxas) and its HGMMA / IGMMA instructions (cuobjdump),
              which every product kernel there must have; none of them may
              spill or have its wgmma serialised by ptxas (C7510-C7520).
              Then the native C++ library (tokenizer, BM25, chunker) from
              native/*.cc into build/native/: compiler, seconds, path; it
              must load.
3. kernel  -- every kernel (K1-K11) at its main-path shapes (and K1-K5, K7,
              K8, K10 and K11 again at the bge-base width: head_dim 64,
              hidden 768, D 768; K9 at heads of 128: Qwen2-1.5B's 12 / 2
              at pad 1,100 and 0, Qwen2-7B's 28 / 4 and Llama-3-8B's 32 / 8,
              each with its device time and, at S=4,096, a wrong-K9
              control that must fail), against its
              plain PyTorch version on the
              same inputs, with its time, the
              plain version's, the library call's where one PyTorch call
              computes the same function (for K3, the three-call
              F.linear -> F.gelu -> F.linear beside it instead, for K4 the
              two-call torch.mm -> torch.topk), and its
              bound (the larger of bytes at 3.35 TB/s and operations at the
              peak rate of their type; for K2 and K11 also one exponential
              per live score at 16 a clock per SM). K5, K6 and K7 must
              run their int8 / bf16 Hopper sweep and no older one
              (torch.profiler's kernel names). K2, K10 and K11 at heads of
              64 must run the attention kernels of the path their wrapper
              picks for S (``fa.fwd_kernel``, ``fa.bwd_launch_plan``) and
              no other: torch.profiler's names in one fresh process, a
              ``kernel_path`` line each; every attention kernel line names
              its path.
              K2 at 64 also at the wide ingest's 68 x 512 and on rows
              whose last live key lies inside a key tile; at its table
              shape two controls (key tile 0 lost, the mask ignored) must
              miss its 3e-2; K10 at 64 carries the mask-ignored control and
              the run-to-run bit check at every S (128, 100 and 64 fused,
              512 two kernels).
4. slice   -- full-width seeded random checkpoints (bge-small, gte-small,
              MiniLM-L-6 cross-encoder) are written to a temporary data dir;
              Runtime.build(device="cuda") (flat bf16 indexes) ingests a
              seeded Marker-JSON corpus of >= 2,048 children and answers the
              9 golden questions through RAGEngine.query.
5. profile -- the golden questions, reworded past the caches, once more
              under torch.profiler: device busy and idle share, device time
              by kernel, and the package's host spans.
6. ivf     -- the same checkpoints and corpus through Runtime.build with
              INDEX_KIND=ivf (planned capacity 131,072 -> nlist 1,024,
              list_size 256, nprobe 64): ingest, the 9 golden questions, then
              tune_indexes() (IVF_AUTOTUNE_RECALL=0.9, sample 32); profiled
              like phase 5.
7. int8    -- the flat runtime's indexes are saved and its data dir copied;
              Runtime.build there with INDEX_DTYPE=int8 reloads and
              re-quantizes them and answers the 9 golden questions.
7b. sharded -- multi-GPU serving on the one card (every shard on
              cuda:0). The gate: Runtime.build with INDEX_SHARDS=4 and one
              encode replica on a copy of phase 4's data dir (without
              feedback.db) reloads its flat checkpoints into 4-shard
              ShardedFlatIndexes and answers the 9 golden questions; each
              dense search it made must give phase 4's index's ids on the
              same query vector (as sets within score ties of 1e-5), and
              each question whose top children differ from phase 4's
              (outside ties of 2^-7 of the final scores) must have had a
              dense top k reordered within such a tie. Runtime.build with
              INDEX_SHARDS=4 and ENCODE_DP=2 (two encode replicas on the
              card), flat bf16, phase 4's checkpoints and NullLLM: ingest,
              the 9 golden questions (K7 once a shard and a search, K4 and
              K5 never, K1-K3 on both replicas), 64 children's DP
              embeddings against the one-device encoder (cosine >= 0.9999),
              ingest rate and p50 beside phase 4's; its top children
              against phase 4's are reported. Then INDEX_KIND=ivf on 4 shards: ingest,
              tune_indexes (nprobe on every shard), the 9 questions, K8 on
              every shard. Then the index classes at scale, held bit for
              bit to the plain composition (K7's plain version per shard,
              the same merge) on exact-grid rows, CUDA events:
              ShardedFlatIndex at 4 x 262,144 rows of D 384 (bf16, int8)
              and 4 x 131,072 of D 768, Bq 8 and 128, k 24, beside one
              FlatIndex over the same rows through K7 and K4 (K5 for int8);
              ShardedIVFIndex at 4 x 262,144 clustered rows, nlist 1,024,
              nprobe 64: recall@24 against the exact top 24, ms a search
              (the 10M-chunk configuration cut to 1,048,576 rows).
8. serve   -- the HTTP surface: Runtime.build on another copy of the flat
              data dir (without feedback.db, whose result cache would
              answer), make_processor, make_app, and make_server on
              127.0.0.1 port 0 in a thread; /health, the 9 golden
              questions posted to /search from 3 client threads at once
              (each with phase 4's top-5 child ids, and together with its
              launch counts), then reworded one at a time, 3 questions to
              /search-stream (events chunks, answer, complete), a bad query
              (400) and an unknown path (404); HTTP p50 and max ms of both
              beside phase 4's engine p50; the server and the app's threads
              stopped.
8b. load   -- the default serving runtime (SERVE_MICROBATCH=1,
              MICROBATCH_DIRECT=32, MAX=192) under load on copies of the
              flat data dir: 64 threads x 192 unique questions through
              RAGEngine.query, batched and then with SERVE_MICROBATCH=0
              (QPS, p50, p95, every batcher's counts; the sweep waves and the
              rerank coalesce, K1-K4 launch, K4 fewer times than questions;
              each question's query embeddings, rerank candidates and raw
              logits as unbatched within tolerances, its top-5 reported);
              16 HTTP clients on
              /search at MICROBATCH_DIRECT=2, below the app's 8 workers; 4
              concurrent query_stream calls on the local LLM in f32 at
              MICROBATCH_DIRECT=1 through the continuous decode engine (K9
              from its row prefills; each stream's text as the same prompt's
              per-request stream).
9. backends -- the saved flat index loaded with backend pallas_exact and
              pallas_bucketed (bf16) and pallas_fused (bf16 and int8): the
              golden questions' query vectors through K6, K7, K4 and K5,
              each against its plain version, with recall@24 against K6.
10. parity -- 16 corpus texts through the same weights on the CPU (plain
              versions, f32) against the card's bf16 embeddings and logits.
10b. wide  -- the bge-base width: seeded random checkpoints at the
              bge-base-en-v1.5 and gte-base shapes (hidden 768, 12 layers,
              12 heads of 64, FFN 3,072) as the baai and gte encoders beside
              the MiniLM-L-6 reranker; Runtime.build(device="cuda") on flat
              bf16 ingests phase 4's corpus and answers the 9 golden
              questions (K1-K3 at the wide shapes on the ingest, K1-K4 on the
              queries); 16 children's embeddings against the f32 CPU path at
              cosine >= 0.999; a profile as in phase 5; the indexes reloaded
              as int8 answer the 9 questions through K5 at D=768. p50s and
              children/s printed.
10c. multivector -- the late-interaction tier: phase 4's bge-small
              checkpoint in a TokenEncoder on the card and a
              MultiVectorIndex (384, 128 tokens, 4,096 children, bf16)
              plugged into a fresh flat runtime's pipeline and hybrid
              retriever, CHILD_USE_MULTIVECTOR=1: ingest of the 27
              documents, the 9 golden questions (the hybrid.multivector span
              with non-empty lists), K2/K3 launched by the token encoder,
              MaxSim and token vectors against the CPU in f32.
10d. multivector_scale -- MaxSim at scripts/bench_multivector.py's
              configuration (20,480 x 128 x 384 bf16, 2.01 GB, made on the
              card; 16-token queries, k 10): ms a search (median, IQR),
              the sweep's ms, its bound, peak memory, one query against a
              plain f32 recomputation.
11. llm    -- a seeded random-weight checkpoint at the Qwen2-0.5B shape;
              Runtime.build with LLM_PROVIDER=local (LLM_MAX_NEW_TOKENS =
              LLM_SMOKE_NEW_TOKENS) on a copy of the flat data dir; warm()
              (the 4,096 prompt bucket), the 9 golden questions through
              RAGEngine.query and 3 through query_stream, none degraded;
              K9 launched 24 times per prefill; generate against the joined
              stream, a generate_many wave, LLM_DTYPE=int8.
12. profile -- the llm runtime under torch.profiler (2 questions).
13. decoder_parity -- the 0.5B weights on the CPU (f32) against the card
              (bf16, K9): last-position logits and each layer's attention
              output by cosine, with controls that must fail.
13a. llm_d128 -- a head-128 decoder at full width: a seeded random-weight
              checkpoint at the Qwen2-1.5B shape (28 layers, 12 query and 2
              kv heads of 128) on the byte-level BPE fixture, served with
              LLM_PROVIDER=local on a copy of the flat data dir; warm(), 3
              golden questions through query and 1 through query_stream,
              none degraded; K9 (its head-128 kernel) 28 times a prefill, a
              4,096-token prefill; prints the write, build and warm seconds,
              query p50 and max, prefill ms by bucket, verify-step ms.
13b. decoder_tp -- tensor-parallel decoding of the 0.5B shape on tp 2, 2
              ranks sharing the card over gloo: batch 4 of left-padded
              prompts up to 512 tokens, 16 greedy tokens; the ranks' tokens
              identical; against the single-device port, bf16 prefill and
              decode-step logits (cosine >= 0.995) and f32 tokens up to the
              first near tie; K9 24 times a prefill at 7 / 1 local heads, 2
              all-reduces a layer; then dryrun_multichip's section 5 on 4
              ranks.
14. train  -- fine-tuning at full width, bf16 compute on f32 master weights:
              contrastive steps at the bge-small shape (256 pairs x 2 x 128),
              listwise steps at the MiniLM-L-6 shape (64 groups x 4 x 64),
              each with K2, K10 and K3 launched once per layer and encode and
              K1 never; one step under torch.profiler; the retrieval uplift
              (train_uplift's defaults), which must reach 0.5.
15. train_parity -- one contrastive step's gradients on the card (bf16) against
              the CPU (f32, plain versions) by cosine per leaf group, with
              wrong-K10 controls that must fail.
16. train_tp -- data- and tensor-parallel training through K11: 4 ranks
              (parallel.launch.spawn; on one card they share it over gloo)
              run contrastive steps at the bge-small shape on dp2 x tp2 and
              dp1 x tp4 (64 pairs x 2 x 128) and listwise steps at the
              MiniLM-L-6 shape on dp2 x tp2 (32 groups x 4 x 64); K11 once
              per layer, encode and step on every rank, K3 and K1 never,
              replicated leaves bit-identical across TP ranks; one dp2 x tp2
              step's gathered gradients against phase 15's CPU step by cosine
              and norm ratio per leaf group, with three controls that must
              fail.
17. train_wide -- training at the bge-base width (hidden 768, 12 heads of
              64): contrastive steps at 12 layers (256 pairs x 2 x 128,
              K10 at head_dim 64), listwise steps of a 12-layer
              bge-base-width cross-encoder (64 groups x 4 x 64), phase 15's
              parity and controls at 2 layers of full width, one dp2 x tp2
              and one dp1 x tp4 step (K11 at 6 and 3 local heads of 64)
              against the single-GPU step, scripts/train_rerank.py
              --feedback-db --model-path on a seeded feedback.db and a
              seeded 12-layer cross-encoder whose output then serves the 9
              golden questions as the reranker, and scripts/train_uplift.py
              --hidden 768 (its f32 D-768 eval index on K4).
18. cli    -- the operator CLI in process on the card, each script through
              its ``main(argv)`` under LLM_PROVIDER=local: a seeded
              random-weight Qwen2-0.5B-shape checkpoint whose tokenizer.json
              is the committed byte-level BPE fixture
              (tests/data/bpe/qwen2_style, its vocabulary padded to the
              model's 151,936 ids by tokens no merge reaches) and a ChatML
              template; ingest_all of phase 4's corpus into a fresh data
              dir, check_collections (its parents and children must be
              ingest_all's), test_full_flow, pc_retrieval_smoke,
              pc_llm_answer (every answer the model's, none NullLLM's),
              recall_eval; every script returns 0 and builds its runtime
              on the card, the reader's ids on the fixture's probe strings
              are the ids tokenizers wrote there, K1-K4 and K9 launch;
              prints the phase's seconds, the reader's encode ms of a
              4,096-token prompt and recall_eval's value.
19. the script's total seconds, the ``kernels`` line (K2, K10 and K11
              with their head_dim-64 case as ``d64``, K10 and K11 its
              launches as ``launches_d64``, K9 with its head_dim-128 case as ``d128``,
              its launches on the TP ranks as ``launches_tp`` and on
              llm_d128 as ``launches_d128``, K2 and K3
              with the multivector path's as ``launches_multivector``), then
              the last line ``{"ok": true, "device": ...}``.

Each path (phases 4, 6, 7, each part of 7b, 8, each part of 8b, 9, each
part of 10b, 10c, 11, 13a, 13b (in its ranks' fresh processes), each part of
14, 16 and 17, and 18) sets every launch counter to 0 just before it
and reads them just after: each kernel of that path must have run.

Exits non-zero (and prints no result line) on any failure, when CUDA is not
available, or when the port's package is not beside this file.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
# LLM_MAX_NEW_TOKENS of the llm phases. Random weights never emit eos, so
# every generation runs to this cap; the served default, 256, adds about 4
# minutes to the script for no further coverage of the path.
LLM_SMOKE_NEW_TOKENS = 64
# Decoder parity bars (phase_decoder_parity): card bf16 against CPU f32.
# Each sits between the right kernel's reading and the controls' (PERF.md).
DECODER_LOGITS_COSINE = 0.995
DECODER_ATTENTION_COSINE = 0.999

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
    "bucketed_topk_fused": ("financial_rag_tpu_torch/csrc/bucketed_topk.cu + "
                            "financial_rag_tpu_torch/csrc/flat_sweep.cuh",
                            "financial_rag_tpu/ops/topk.py:200"),
    "topk_matmul": ("financial_rag_tpu_torch/csrc/topk_exact.cu + "
                    "financial_rag_tpu_torch/csrc/flat_sweep.cuh",
                    "financial_rag_tpu/ops/topk.py:109"),
    "bucketed_topk": ("financial_rag_tpu_torch/csrc/bucketed_topk.cu + "
                      "financial_rag_tpu_torch/csrc/flat_sweep.cuh",
                      "financial_rag_tpu/ops/topk.py:180"),
    "probe_scores": ("financial_rag_tpu_torch/csrc/ivf_probe.cu",
                     "financial_rag_tpu/ops/ivf_probe.py:41"),
    "causal_flash_prefill": ("financial_rag_tpu_torch/csrc/causal_flash.cu",
                             "financial_rag_tpu/ops/causal_flash.py:42"),
    "flash_attention_bwd": ("financial_rag_tpu_torch/csrc/flash_attention_bwd.cu",
                            "financial_rag_tpu/ops/flash_attention.py:55"),
    "flash_attention_tp": ("financial_rag_tpu_torch/csrc/flash_attention.cu + "
                           "financial_rag_tpu_torch/csrc/flash_attention_bwd.cu",
                           "financial_rag_tpu/ops/flash_attention.py:168"),
}
TOPK_KERNELS = ("packed_topk_fused", "bucketed_topk_fused", "topk_matmul", "bucketed_topk")
# the kernels each served path must launch
FLAT_PATH = ("masked_mean_l2_normalize", "flash_attention", "fused_ffn", "packed_topk_fused")
IVF_PATH = ("masked_mean_l2_normalize", "flash_attention", "fused_ffn", "probe_scores")
INT8_PATH = ("masked_mean_l2_normalize", "flash_attention", "fused_ffn", "bucketed_topk_fused")
SERVE_PATH = FLAT_PATH   # the HTTP server over the flat bf16 indexes
LLM_PATH = ("masked_mean_l2_normalize", "flash_attention", "fused_ffn", "packed_topk_fused",
            "causal_flash_prefill")
TRAIN_PATH = ("flash_attention", "flash_attention_bwd", "fused_ffn")
# the counter of each kernel whose module counts more than one (K10 and K11
# beside K2; K11's backward launches count apart from its forward ones)
COUNTER_ATTR = {"flash_attention_bwd": "BWD_LAUNCHES", "flash_attention_tp": "TP_LAUNCHES",
                "flash_attention_tp_bwd": "TP_BWD_LAUNCHES"}

# the Qwen2-0.5B shape (HF config.json of Qwen/Qwen2-0.5B), full width and depth
QWEN2_05B = {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
             "vocab_size": 151936, "hidden_size": 896, "intermediate_size": 4864,
             "num_hidden_layers": 24, "num_attention_heads": 14, "num_key_value_heads": 2,
             "max_position_embeddings": 32768, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
             "tie_word_embeddings": True, "hidden_act": "silu", "torch_dtype": "bfloat16"}
# the Qwen2-1.5B shape (HF config.json of Qwen/Qwen2-1.5B-Instruct), full
# width and depth: 12 query and 2 kv heads of 128, so K9's head-128 kernel
QWEN2_15B = {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
             "vocab_size": 151936, "hidden_size": 1536, "intermediate_size": 8960,
             "num_hidden_layers": 28, "num_attention_heads": 12, "num_key_value_heads": 2,
             "max_position_embeddings": 32768, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
             "tie_word_embeddings": True, "hidden_act": "silu", "torch_dtype": "bfloat16"}
DEGRADED = "LLM unavailable"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def _counter_modules():
    from financial_rag_tpu_torch.ops import (causal_flash, flash_attention, fused_ffn, ivf_probe,
                                             pool_norm, topk)

    return {"masked_mean_l2_normalize": pool_norm, "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention, "flash_attention_tp": flash_attention,
            "flash_attention_tp_bwd": flash_attention,
            "fused_ffn": fused_ffn, "probe_scores": ivf_probe,
            "causal_flash_prefill": causal_flash,
            **{name: topk for name in TOPK_KERNELS}}


def reset_launches() -> None:
    """Every kernel's launch count to 0 (the sweeps of ops/topk.py count in
    one Counter, keyed by wrapper name; K10 and K11 in COUNTER_ATTR's
    counters of K2's module)."""
    for name, mod in _counter_modules().items():
        if name in TOPK_KERNELS:
            mod.LAUNCHES[name] = 0
        else:
            setattr(mod, COUNTER_ATTR.get(name, "LAUNCHES"), 0)


def read_launches() -> dict:
    return {name: (mod.LAUNCHES[name] if name in TOPK_KERNELS
                   else getattr(mod, COUNTER_ATTR.get(name, "LAUNCHES")))
            for name, mod in _counter_modules().items()}


def check_path_launched(path: tuple, launches: dict, what: str) -> None:
    missing = [k for k in path if launches[k] <= 0]
    check(not missing, f"{what}: kernels never launched: {missing} ({launches})")


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


def device_ms(torch, fn, calls: int = 20) -> float:
    """The device time of one call of fn(): its kernels' own time under
    torch.profiler, averaged over ``calls`` calls; gaps between launches
    do not count."""
    prof, _ = profiled(torch, lambda attempt: [fn() for _ in range(calls)])
    return sum(e.time_range.end - e.time_range.start for e in device_events(prof)) / 1e3 / calls


@functools.lru_cache(maxsize=None)
def exp_per_s() -> float:
    """The SFUs' exponential rate: 16 a clock on each of 132 SMs, at the
    card's maximum SM clock as ``nvidia-smi --query-gpu=clocks.max.sm``
    reports it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi clocks failed: {smi.stderr}")
    return 16 * 132 * float(smi.stdout.split()[0]) * 1e6


def bound_terms(bytes_moved: float, ops: float, op_type: str, exps: float = 0.0) -> dict:
    """The bytes at the memory rate, the operations at their peak rate and
    the exponentials at the SFUs' rate, each in ms."""
    return {"bytes_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / PEAK_OPS_PER_S[op_type] * 1e3,
            "exps_ms": exps / exp_per_s() * 1e3 if exps else 0.0}


def bound(bytes_moved: float, ops: float, op_type: str, exps: float = 0.0):
    """The larger of the bytes at the memory rate and the operations at
    their peak rate; ``exps`` exponentials at the SFUs' rate count among the
    operations."""
    t = bound_terms(bytes_moved, ops, op_type, exps)
    t_ops = max(t["ops_ms"], t["exps_ms"])
    return (t["bytes_ms"], "bytes") if t["bytes_ms"] >= t_ops else (t_ops, "operations")


def attention_fwd_bound(torch, mask, heads: int, head_dim: int = 32):
    """K2's (and K11's) bound at a [B,S] padding mask: q read and the
    output written once, K and V of the live keys only (a row with no live
    key attends to all S), the bias; the two products and one exponential
    per live score."""
    b, s = mask.shape
    lens = mask.sum(dim=1)
    live = int(torch.where(lens > 0, lens, s).sum().item())
    width = heads * head_dim
    return bound(2 * b * s * width * 2 + 2 * live * width * 2 + b * s * 4,
                 4 * heads * head_dim * s * live, "bf16", exps=heads * s * live)


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
            "exp_per_s": exp_per_s(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


# the sources of the kernels redesigned for Hopper (wgmma from a ring of
# shared-memory stages): the build phase reports their ptxas resources and requires HGMMA in
# the SASS of every product kernel they define (not of K9's f32 kernel, K3's
# reduce, K4's f32 sweep and merge, K5's extract, K6's merge, K7's write, or
# the older CUDA-core / mma.sync sweeps that f32 corpora keep; K7's int8 and
# bf16 sweep is K5's bucketed_wgmma_sweep_kernel)
WGMMA_SOURCES = ("flash_attention.cu", "fused_ffn.cu", "flash_attention_bwd.cu", "causal_flash.cu",
                 "packed_topk.cu", "bucketed_topk.cu", "topk_exact.cu")
WGMMA_KERNELS = ("bf16", "attn_bwd", "attn_fwd_kernel", "attn_fwd_d64_kernel", "ffn_fwd_kernel",
                 "ffn_wide_kernel",
                 "packed_sweep_bf16", "wgmma_sweep")


def ptxas_resources(log_text: str) -> dict:
    """{source: {mangled kernel: {registers, smem_bytes, spill_stores,
    spill_loads, wgmma_serialised}}} from the -Xptxas -v lines of the build
    log; ``wgmma_serialised`` lists the codes of ptxas's notes that it
    serialised the kernel's wgmma (C7510-C7520), where it has any."""
    out, source, fn = {}, None, None
    for line in log_text.splitlines():
        if line.startswith("== "):
            source, fn = line.split()[1], None
            continue
        m = re.search(r"\((C75[12]\d)\)[^']*wgmma[^']*function '([^']+)'", line)
        if m:
            entry = out.setdefault(source, {}).setdefault(m.group(2), {})
            entry.setdefault("wgmma_serialised", []).append(m.group(1))
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out.setdefault(source, {}).setdefault(fn, {})
            continue
        if fn is None:
            continue
        entry = out[source][fn]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def sass_hgmma_counts(library: str):
    """{mangled kernel: number of warpgroup MMA instructions, HGMMA (bf16,
    f16) and IGMMA (int8)} from cuobjdump, or None
    where the toolkit has no cuobjdump."""
    cuobjdump = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not cuobjdump.exists():
        return None
    sass = subprocess.run([str(cuobjdump), "-sass", library], capture_output=True, text=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HGMMA" in line or "IGMMA" in line):
            counts[fn] += 1
    return counts


def phase_build(kernel_lib, log_dir):
    """Builds the library from csrc/ and reports, for each kernel of the
    wgmma sources, its registers, shared memory and spills (ptxas) and its
    HGMMA / IGMMA instructions (cuobjdump, in the entry's ``hgmma``); a
    product kernel there without them, one that spills registers, or one
    whose wgmma ptxas serialised (C7510-C7520), fails."""
    t0 = time.perf_counter()
    path = kernel_lib.build()
    kernel_lib.load()
    seconds = time.perf_counter() - t0
    log = kernel_lib.BUILD_INFO.get("log")
    if log_dir and log:
        shutil.copy(log, Path(log_dir) / "kernel_build.log")
    emit({"phase": "build", "seconds": round(seconds, 3), "library": str(path)})
    check(log is not None, "the build log is missing: the library must be built in this run")
    resources = ptxas_resources(Path(log).read_text())
    hgmma = sass_hgmma_counts(str(path))
    names = [fn for src in WGMMA_SOURCES for fn in resources.get(src, {})]
    missing, spilled, serialised = [], [], []
    for src in WGMMA_SOURCES:
        for fn, res in resources.get(src, {}).items():   # fn: the mangled kernel name
            entry = {"phase": "build", "source": src, "kernel": fn, **res}
            if any(key in fn for key in WGMMA_KERNELS) and res.get("spill_stores", 0):
                spilled.append(fn)
            if any(key in fn for key in WGMMA_KERNELS) and res.get("wgmma_serialised"):
                serialised.append((fn, res["wgmma_serialised"]))
            if hgmma is not None:
                entry["hgmma"] = hgmma.get(fn, 0)
                if any(key in fn for key in WGMMA_KERNELS):
                    entry["wgmma_in_sass"] = entry["hgmma"] > 0
                    if not entry["hgmma"]:
                        missing.append(fn)
            emit(entry)
    check(names, f"no ptxas resource lines for {WGMMA_SOURCES} in the build log")
    check(not missing, f"no HGMMA or IGMMA in the SASS of {missing}")
    check(not spilled, f"ptxas spills registers in {spilled}")
    check(not serialised, f"ptxas serialised the wgmma of {serialised}")
    phase_build_native()


def phase_build_native():
    """The native C++ library (WordPiece, BM25, the chunker's word scan)
    that the tokenizer, the BM25 scorer and the chunker use: built from
    financial_rag_tpu_torch/native/*.cc into build/native/ by the host C++
    compiler. Its Python fallbacks would hide a failed build, so it must
    load here."""
    from financial_rag_tpu_torch import native

    t0 = time.perf_counter()
    ok = native.available()
    seconds = time.perf_counter() - t0
    info = native.BUILD_INFO
    emit({"phase": "build", "native": ok, "compiler": info.get("compiler", native.compiler()),
          "compile_s": info.get("seconds"), "seconds": round(seconds, 3),
          "library": info.get("library", str(native.lib_path()))})
    check(ok, "the native library did not build or load (see the log)")


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

    cases = []
    for b, s, holed in ((256, 512, False), (68, 512, True), (8, 64, False)):
        hidden = randn(b, s, H, dtype=bf16)
        mask = padded_mask(b, s, fully_masked_row=holed)
        if holed:   # an ingest batch with weights: holes, fractional weights
            mask = mask * (torch.rand(b, s, generator=gen, device=dev) > 0.2).float()
            mask[1::2] *= 0.5
        live = int((mask != 0).sum().item())
        label = ",holed+fractional+empty row" if holed else ""
        cases.append(("masked_mean_l2_normalize", f"B={b},S={s},H={H},bf16{label}",
                      lambda h=hidden, m=mask: pn.masked_mean_l2_normalize(h, m),
                      lambda h=hidden, m=mask: pn.masked_mean_l2_normalize_plain(h, m),
                      None, max_abs_cmp(1e-5),
                      bound(live * H * 2 + b * s * 4 + b * H * 4, 2 * live * H, "f32")))

    for b, s in ((256, 512), (256, 128), (8, 64), (32, 256)):
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
                      sdpa, max_abs_cmp(3e-2), attention_fwd_bound(torch, mask, NH)))

    w1, w2 = randn(H, I, dtype=bf16, scale=H ** -0.5), randn(I, H, dtype=bf16, scale=0.012)
    b1, b2 = randn(I, dtype=bf16, scale=0.1), randn(H, dtype=bf16, scale=0.1)
    for b, s in ((256, 512), (256, 128), (8, 64)):
        x = randn(b, s, H, dtype=bf16)
        n = b * s
        cases.append(("fused_ffn", f"N={n} (B={b},S={s}),H={H},I={I},bf16",
                      lambda x=x: ffn.fused_ffn(x, w1, b1, w2, b2),
                      lambda x=x: ffn.fused_ffn_plain(x, w1, b1, w2, b2),
                      ThreeCallFFN(F, x, w1, b1, w2, b2), max_abs_cmp(3e-2),
                      bound(2 * n * H * 2 + (2 * H * I + I + H) * 2, 4 * n * H * I, "bf16")))

    d, k = H, 24
    # (Bq, N): the table's shape; a query batch over it; the served shape (one
    # query per launch over the index capacity of the slice phase); a
    # smaller corpus in bf16 and in f32
    # the load phase's wave sweeps: the batcher pads its rows to 192
    # (MICROBATCH_MAX) and doubles to 384 on an overshoot, over the index
    # capacity of the slice phase
    for bq, n, dtype, label in ((128, 102400, bf16, "bf16"), (8, 102400, bf16, "bf16"),
                                (1, 4096, bf16, "bf16"), (192, 4096, bf16, "bf16"),
                                (384, 4096, bf16, "bf16"), (128, 16384, bf16, "bf16"),
                                (128, 16384, torch.float32, "f32")):
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
                      TwoCallTopk(torch, queries, x, k) if dtype == bf16 else None, topk_cmp(bits),
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
    cases += sweep_cases(torch, gen, randn)
    cases += probe_cases(torch, gen, randn)
    cases += causal_cases(torch, F, randn)
    cases += attention_bwd_cases(torch, F, randn, padded_mask)
    cases += attention_tp_cases(torch, F, randn, padded_mask)
    cases += wide_cases(torch, F, gen, randn, padded_mask)
    # K10 and K11 at heads of 64 last, so that every earlier case keeps its inputs
    cases += attention_bwd_cases(torch, F, randn, padded_mask, head_dim=64, shapes=WIDE_BWD_SHAPES)
    cases += attention_tp_cases(torch, F, randn, padded_mask, head_dim=64,
                                shapes=TP_LOCAL_SHAPES[:2])
    for heads, shapes in CAUSAL_128_CASES:
        cases += causal_cases(torch, F, randn, heads=heads, shapes=shapes)
    cases += wide_attention_cases(torch, F, randn, padded_mask)
    return cases


def topk_cmp(bits, exact=False):
    """K4 against its plain version: exact (exact-grid data) or >= 99% of
    ids identical with every differing pair within one quantum of the
    packed score (bits low mantissa bits hold the tile)."""
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


# (kernel, N, corpus, two-call yardstick, queries) of the wide sweep cases:
# the table's shape (with its two-call time) and the int8 runtime's served
# launch for K5, in int8 and bf16, and K7 at the table's shape (K6 stays at
# D <= 384)
WIDE_SWEEP_PLAN = (("bucketed_topk_fused", 102400, "int8", True, 128),
                   ("bucketed_topk_fused", 4096, "int8", False, 1),
                   ("bucketed_topk_fused", 102400, "bf16", True, 128),
                   ("bucketed_topk_fused", 4096, "bf16", False, 1),
                   ("bucketed_topk", 102400, "bf16", False, 128),
                   ("bucketed_topk", 102400, "int8", False, 128))


def wide_cases(torch, F, gen, randn, padded_mask):
    """The bge-base width (hidden 768, 12 heads of 64, FFN 3,072, index D
    768), after every D=384 case so that those keep their inputs: K1 at
    B=256 S=512; K2 (``flash_attention@64``, wide_attention_case) at B=256
    S=512 with its two controls, B=256 S=128 and B=8 S=64 (a fully masked
    row); K3 at N=131,072, the wide ingest's 68 x 512 and N=512;
    K4 at Bq=128 and Bq=8 over N=102,400, the load phase's wave (Bq=192
    over 4,096) and exact-grid data with ties; K5 and K7 (WIDE_SWEEP_PLAN)
    with exact-grid cases; K8 at a served request's B=8 P=64. Tolerances
    and bounds as at 384."""
    from financial_rag_tpu_torch.ops import flash_attention as fa
    from financial_rag_tpu_torch.ops import fused_ffn as ffn
    from financial_rag_tpu_torch.ops import pool_norm as pn
    from financial_rag_tpu_torch.ops import topk

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    H, NH, I = 768, 12, 3072
    hd = H // NH
    cases = []
    b, s = 256, 512
    hidden = randn(b, s, H, dtype=bf16)
    mask = padded_mask(b, s)
    live = int(mask.sum().item())
    cases.append(("masked_mean_l2_normalize", f"B={b},S={s},H={H},bf16",
                  lambda h=hidden, m=mask: pn.masked_mean_l2_normalize(h, m),
                  lambda h=hidden, m=mask: pn.masked_mean_l2_normalize_plain(h, m),
                  None, max_abs_cmp(1e-5),
                  bound(live * H * 2 + b * s * 4 + b * H * 4, 2 * live * H, "f32")))

    for b, s in ((256, 512), (256, 128), (8, 64)):
        q, k, v = (randn(b, s, H, dtype=bf16) for _ in range(3))
        mask = padded_mask(b, s, fully_masked_row=(b == 8))
        bias = torch.where(mask > 0, 0.0, -1e9).float()
        controls = ()
        if (b, s) == (256, 512):   # the table shape carries the two controls
            lost = bias.clone()
            lost[:, :64] = -1e9
            controls = (("lose_key_tile_0", lambda q=q, k=k, v=v, lost=lost: fa.flash_attention(
                            q, k, v, lost, num_heads=NH)),
                        ("mask_ignored", lambda q=q, k=k, v=v, b=b, s=s: fa.flash_attention(
                            q, k, v, torch.zeros(b, s, device=dev), num_heads=NH)))
        cases.append(wide_attention_case(torch, F, q, k, v, mask, bias, NH, hd, controls))

    w1, w2 = randn(H, I, dtype=bf16, scale=H ** -0.5), randn(I, H, dtype=bf16, scale=0.012)
    b1, b2 = randn(I, dtype=bf16, scale=0.1), randn(H, dtype=bf16, scale=0.1)
    for b, s in ((256, 512), (68, 512), (8, 64)):
        x = randn(b, s, H, dtype=bf16)
        n = b * s
        cases.append(("fused_ffn", f"N={n} (B={b},S={s}),H={H},I={I},bf16",
                      lambda x=x: ffn.fused_ffn(x, w1, b1, w2, b2),
                      lambda x=x: ffn.fused_ffn_plain(x, w1, b1, w2, b2),
                      ThreeCallFFN(F, x, w1, b1, w2, b2), max_abs_cmp(3e-2),
                      bound(2 * n * H * 2 + (2 * H * I + I + H) * 2, 4 * n * H * I, "bf16")))

    d, k = H, 24
    for bq, n in ((128, 102400), (8, 102400), (192, 4096)):
        x = randn(n, d)
        x = (x / x.norm(dim=1, keepdim=True)).to(bf16)
        queries = randn(bq, d)
        queries = queries / queries.norm(dim=1, keepdim=True)
        valid = (torch.rand(n, generator=gen, device=dev) > 0.03).float()
        bits = max((n // 1024 - 1).bit_length(), 1)
        cases.append(("packed_topk_fused", f"Bq={bq},N={n},D={d},k={k},bf16",
                      lambda q=queries, x=x, v=valid: topk.packed_topk_fused(q, x, v, k),
                      lambda q=queries, x=x, v=valid: topk.packed_topk_fused_plain(q, x, v, k),
                      TwoCallTopk(torch, queries, x, k), topk_cmp(bits),
                      bound(n * d * 2 + n * 4 + bq * d * 4 + bq * k * 8, 2 * bq * n * d, "bf16")))
    bq, n = 128, 16384
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
    cases += sweep_cases(torch, gen, randn, d=d, plan=WIDE_SWEEP_PLAN,
                         grid=("bucketed_topk_fused", "bucketed_topk"))
    cases += probe_cases(torch, gen, randn, d=d, shapes=((8, 64),))
    return cases


def attention_cmp(tol, controls=()):
    """Within ``tol`` of the plain version at every element (K2's check);
    each control, the kernel run on inputs it must not be given (a key tile
    lost, the padding mask ignored), must miss the same bound."""
    def cmp(a, b):
        err = (a.float() - b.float()).abs().max().item()
        detail = {"tol": tol}
        ok = err <= tol
        for label, control in controls:
            c = (control().float() - b.float()).abs().max().item()
            detail[f"control_{label}_max_abs_err"] = c
            ok = ok and c > tol
        return err, ok, detail
    return cmp


# (name, shape, path, probe, path kernels) of the attention cases whose
# path phase_kernels checks in a fresh process
PATH_CHECKS = []


def path_ran(ran, kernels) -> bool:
    """Whether the attention kernels that ran are ``kernels``, no other."""
    ran = [n for n in ran if "attn_" in n]
    return (all(any(k in n for n in ran) for k in kernels)
            and all(any(k in n for k in kernels) for n in ran))


def with_path(cmp, name: str, shape: str, path: str, kernels, probe=None):
    """``cmp``, and the path the wrapper picks (``path``, its ``kernels``),
    named in the detail. With a ``probe`` ("fwd" or "bwd", B, S, H, heads)
    the case is also queued for phase_kernels' check that the kernels that
    ran are those, no other: in one fresh process, since in a process as
    long as this one the profiler now and then records nothing or only
    part of a call, with the results right."""
    if probe is not None:
        PATH_CHECKS.append((name, shape, path, probe, kernels))

    def check(a, b):
        err, ok, detail = cmp(a, b)
        detail["path"] = path
        return err, ok, detail
    return check


FRESH_ATTENTION_PROBE = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from financial_rag_tpu_torch.ops import flash_attention as fa
out = []
for kind, b, s, h, heads, kernels in json.loads(sys.argv[1]):
    q, k, v, do = (torch.randn(b, s, h, device="cuda").bfloat16() for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    if kind == "fwd":
        call = lambda: fa.flash_attention(q, k, v, bias, num_heads=heads)
    else:
        call = lambda: fa.flash_attention_bwd(q, k, v, bias, do, num_heads=heads)
    call()
    torch.cuda.synchronize()
    for attempt in range(3):   # a trace that misses a kernel of the path is made again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
        if all(any(k in n for n in names) for k in kernels):
            break
    out.append(names)
print(json.dumps(out))
"""


def fresh_path_names(probes) -> list:
    """The kernel names torch.profiler records for each attention probe
    ([kind, B, S, H, heads, the path's kernels]: random inputs of the
    case's shape, since the wrapper picks its kernels by S and the head
    width alone), made in one fresh Python process."""
    out = subprocess.run([sys.executable, "-c", FRESH_ATTENTION_PROBE, json.dumps(probes)],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"the fresh attention probe failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def wide_attention_case(torch, F, q, k, v, mask, bias, heads: int, hd: int, controls=()):
    """K2 at heads of ``hd`` (the bge-base width's 64) on q, k, v and the
    [B,S] bias from ``mask``: within 3e-2 of the plain version (the
    ``controls`` must miss it), the kernel the wrapper picks for S
    (``fa.fwd_kernel``) and no other, SDPA the library time, the bound
    over the live keys."""
    from financial_rag_tpu_torch.ops import flash_attention as fa

    b, s, h = q.shape

    def sdpa():
        split = lambda x: x.view(b, s, heads, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=bias.to(torch.bfloat16)[:, None, None, :])

    def run():
        return fa.flash_attention(q, k, v, bias, num_heads=heads)

    kernel = fa.fwd_kernel(s, hd)
    return (f"flash_attention@{hd}", f"B={b},S={s},H={h},heads={heads}x{hd},bf16", run,
            lambda: fa.flash_attention_plain(q, k, v, bias, num_heads=heads), sdpa,
            with_path(attention_cmp(3e-2, controls), f"flash_attention@{hd}",
                      f"B={b},S={s},H={h},heads={heads}x{hd},bf16", kernel, (kernel,),
                      probe=("fwd", b, s, h, heads)),
            attention_fwd_bound(torch, mask, heads, head_dim=hd))


def wide_attention_cases(torch, F, randn, padded_mask):
    """K2 at 12 heads of 64 beyond wide_cases (after every other case, so
    that those keep their inputs): the wide ingest's batch, 68 x 512, the
    most launched shape; and B=8 S=512 with rows of 512, 1, 65, 130, 257,
    300 and 511 live keys (the last live key inside a key tile, leading a
    dead one) and a fully masked row (the mean of v)."""
    dev = torch.device("cuda")
    NH, hd = 12, 64
    H = NH * hd
    cases = []
    q, k, v = (randn(68, 512, H, dtype=torch.bfloat16) for _ in range(3))
    mask = padded_mask(68, 512)
    cases.append(wide_attention_case(torch, F, q, k, v, mask, torch.where(mask > 0, 0.0, -1e9).float(),
                                     NH, hd))
    q, k, v = (randn(8, 512, H, dtype=torch.bfloat16) for _ in range(3))
    lens = torch.tensor([512, 1, 65, 130, 257, 300, 511, 0], device=dev)
    mask = (torch.arange(512, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    cases.append(wide_attention_case(torch, F, q, k, v, mask, torch.where(mask > 0, 0.0, -1e9).float(),
                                     NH, hd))
    return cases


class _ModelAxis:
    """The mesh K11 is given in the kernel phase: K11 reads only the size
    of its model axis."""

    def __init__(self, tp: int):
        self.shape = {"model": tp}


# K11 at the local shapes one rank of the train_tp phase gives it (B, S, tp):
# one encode of the 64 contrastive pairs on dp2 x tp2 (32 rows, 6 heads) and
# on dp1 x tp4 (64 rows, 3 heads), and the 32 x 4 listwise rows of 64 tokens
# on dp2 x tp2 (64 rows, 6 heads). The first is the kernels line's shape.
TP_LOCAL_SHAPES = ((32, 128, 2), (64, 128, 4), (64, 64, 2))


def attention_tp_cases(torch, F, randn, padded_mask, head_dim: int = 32,
                       shapes=TP_LOCAL_SHAPES):
    """K11 (flash_attention_tp) at the local shapes of TP_LOCAL_SHAPES: 6 of
    the 12 heads at tp2 (width 192, 384-byte rows), 3 at tp4 (width 96,
    192-byte rows), with padded rows and a fully masked one, each within
    2^-6 of every (position, head) row's largest value of the plain
    version. SDPA on the local heads is the library time. The bound counts
    the local q, k, v and out once each and the bias. K11's backward is K10
    at the same local heads: attention_bwd_cases' checks at these shapes
    (the mask-ignored control included), under the flash_attention_bwd
    name. At head_dim 64 (the bge-base width: 6 and 3 local heads of 64)
    the cases are named ``flash_attention_tp@64`` and
    ``flash_attention_bwd@64``."""
    from financial_rag_tpu_torch.ops import flash_attention as fa

    NH, hd = 12, head_dim
    tag = "" if hd == 32 else f"@{hd}"
    heads_of = "" if hd == 32 else f" of {hd}"
    cases = []
    for b, s, tp in shapes:
        heads = NH // tp
        h = heads * hd
        q, k, v, do = (randn(b, s, h, dtype=torch.bfloat16) for _ in range(4))
        mask = padded_mask(b, s, fully_masked_row=True)
        bias = torch.where(mask > 0, 0.0, -1e9).float()

        def sdpa(q=q, k=k, v=v, bias=bias, b=b, s=s, heads=heads):
            split = lambda x: x.view(b, s, heads, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(
                split(q), split(k), split(v), attn_mask=bias.to(torch.bfloat16)[:, None, None, :])

        run = (lambda q=q, k=k, v=v, bias=bias, tp=tp: fa.flash_attention_tp(
            q, k, v, bias, num_heads=NH, mesh=_ModelAxis(tp), head_dim=hd))
        cases.append((f"flash_attention_tp{tag}",
                      f"B={b},S={s},H={h},local heads={heads}{heads_of} (tp{tp}),bf16", run,
                      lambda q=q, k=k, v=v, bias=bias, heads=heads: fa.flash_attention_plain(
                          q, k, v, bias, num_heads=heads),
                      sdpa, with_path(row_cmp(heads), f"flash_attention_tp{tag}", f"B={b},S={s}",
                                      fa.fwd_kernel(s, hd), (fa.fwd_kernel(s, hd),),
                                      probe=("fwd", b, s, h, heads) if hd == 64 else None),
                      attention_fwd_bound(torch, mask, heads, head_dim=hd)))
        live_pairs = s * int(mask.sum().item()) + s * s
        run = (lambda q=q, k=k, v=v, bias=bias, do=do, heads=heads: fa.flash_attention_bwd(
            q, k, v, bias, do, num_heads=heads))
        path, kernels, _ = fa.bwd_launch_plan(s, hd)
        cases.append((f"flash_attention_bwd{tag}", f"B={b},S={s},H={h},heads={heads}{heads_of} "
                      f"(K11's backward, tp{tp}),bf16", run,
                      lambda q=q, k=k, v=v, bias=bias, do=do, heads=heads:
                      fa.flash_attention_bwd_plain(q, k, v, bias, do, num_heads=heads),
                      SdpaBackward(torch, F, q, k, v, bias, do, heads),
                      with_path(attention_bwd_cmp(
                          heads, lambda q=q, k=k, v=v, do=do, b=b, s=s, heads=heads:
                          fa.flash_attention_bwd(q, k, v, torch.zeros(b, s, device=q.device), do,
                                                 num_heads=heads), again=run),
                                f"flash_attention_bwd{tag}", f"B={b},S={s},K11", path, kernels,
                                probe=("bwd", b, s, h, heads) if hd == 64 else None),
                      bound(7 * b * s * h * 2 + b * s * 4, 5 * 2 * heads * hd * live_pairs, "bf16")))
    return cases


def row_cmp(heads: int):
    """Every (position, head) output row within 2^-6 of its largest value
    (two bf16 ulps of it)."""
    rtol = 2.0 ** -6

    def cmp(a, b):
        rel = row_rel_err(a, b, heads)
        err = (a.float() - b.float()).abs().max().item()
        return err, rel <= rtol, {"rtol": rtol, "max_row_rel_err": rel}
    return cmp


def sweep_cmp(exact: bool):
    """Exact (int8, exact-grid data): ids and scores bit-identical. Real
    bf16 scores sum in another f32 order than the plain version's, so >=
    99.9% of ids identical and every differing pair within 1e-5 in score."""
    def cmp(a, b):
        (ks, ki), (ps, pi) = a, b
        same = ki == pi
        frac = same.float().mean().item()
        diff = (ks - ps).abs()
        err = diff.max().item()
        worst = diff[~same].max().item() if (~same).any() else 0.0
        ok = (frac == 1.0 and err == 0.0) if exact else (frac >= 0.999 and worst <= 1e-5)
        return err, ok, {"ids_identical": frac, "worst_differing_pair": worst, "exact": exact}
    return cmp


def quantize_rows(torch, v):
    """The index's int8 storage: per-row max-abs quantization, weight max/127."""
    m = v.abs().amax(dim=1).clamp_min(1e-12)
    return torch.round(v * (127.0 / m[:, None])).clamp(-127, 127).to(torch.int8), m / 127.0


# (kernel, N, corpus, two-call yardstick, queries) of sweep_cases at D=384
SWEEP_PLAN = (("bucketed_topk_fused", 102400, "int8", True, 128),
              ("bucketed_topk_fused", 4096, "int8", False, 1),    # the int8 runtime's launch
              ("bucketed_topk_fused", 102400, "bf16", False, 128),
              ("topk_matmul", 102400, "bf16", True, 128),
              ("topk_matmul", 16384, "int8", False, 128),
              ("topk_matmul", 4096, "bf16", False, 9),            # the backends phase's launch
              ("bucketed_topk", 102400, "bf16", False, 128),
              ("bucketed_topk", 102400, "int8", False, 128),
              ("bucketed_topk", 4096, "bf16", False, 9),          # the backends phase's launch
              ("bucketed_topk", 32768, "bf16", False, 8))         # a shard of the sharded runtime


def sweep_cases(torch, gen, randn, d: int = 384, plan=SWEEP_PLAN,
                grid=("bucketed_topk_fused", "topk_matmul", "bucketed_topk")):
    """K5, K6, K7 at the JAX package's bench shape (Bq=128, N=102,400, D=384,
    k=24), K5 at the int8 runtime's served shape (one query over 4,096
    rows), K6 int8 at N=16,384, K6 and K7 at the backends phase's shape (9
    queries over 4,096 rows), K7 also in int8 and at a shard of the sharded
    runtime (8 queries over 32,768 rows), and one exact-grid case with
    duplicated rows for each kernel of ``grid``; ``d`` and ``plan`` give
    another width its own cases."""
    from financial_rag_tpu_torch.ops import topk

    dev = torch.device("cuda")
    bq, k = 128, 24
    fns = {"bucketed_topk_fused": (topk.bucketed_topk_fused, topk.bucketed_topk_fused_plain),
           "topk_matmul": (topk.topk_matmul, topk.topk_matmul_plain),
           "bucketed_topk": (topk.bucketed_topk, topk.bucketed_topk_plain)}
    queries = randn(bq, d)
    queries = queries / queries.norm(dim=1, keepdim=True)
    corpora = {}

    def corpus(n, label):
        if (n, label) not in corpora:
            v = randn(n, d)
            v = v / v.norm(dim=1, keepdim=True)
            live = (torch.rand(n, generator=gen, device=dev) > 0.03).float()
            if label == "int8":
                x, w = quantize_rows(torch, v)
                corpora[(n, label)] = (x, w * live)
            else:
                corpora[(n, label)] = (v.to(torch.bfloat16), live)
        return corpora[(n, label)]

    def case(name, n, label, yardstick=False, nq=bq):
        x, valid = corpus(n, label)
        q = queries[:nq]
        run, plain = fns[name]
        esize, op = (1, "int8") if label == "int8" else (2, "bf16")
        # the two-call yardsticks (not library_ms): torch.mm -> torch.topk for
        # bf16, torch._int_mm -> weights -> torch.topk for int8 (more than 16
        # query rows)
        library = None
        if yardstick:
            library = (TwoCallInt8Topk(torch, q, x, valid, k) if label == "int8"
                       else TwoCallTopk(torch, q, x, k))
        # K7's function writes the [Bq, nbuckets] maxima (f32 and int32),
        # the others [Bq, k]
        width = min(4096, n) if name == "bucketed_topk" else k
        return (name, f"Bq={nq},N={n},D={d},k={k},{label}",
                lambda: run(q, x, valid, k), lambda: plain(q, x, valid, k),
                library, sweep_cmp(exact=label == "int8"),
                bound(n * d * esize + n * 4 + nq * d * 4 + nq * width * 8, 2 * nq * n * d, op))

    cases = [case(name, n, label, yardstick=yard, nq=nq) for name, n, label, yard, nq in plan]
    corpora.clear()

    # exact-grid data with repeated rows and dead slots: every score and tie
    # is exact, so each kernel must reproduce its plain version bit for bit
    n = 16384
    xg = torch.randint(-3, 4, (n, d), generator=gen, device=dev).float() / 64.0
    xg[4096:8192] = xg[:4096]
    xg[9000] = xg[5]
    xg = xg.to(torch.bfloat16)
    qg = torch.randint(-3, 4, (bq, d), generator=gen, device=dev).float() / 64.0
    vg = (torch.rand(n, generator=gen, device=dev) > 0.1).float()
    for name in grid:
        run, plain = fns[name]
        width = 4096 if name == "bucketed_topk" else k
        cases.append((name, f"Bq={bq},N={n},D={d},k={k},bf16,exact-grid+ties",
                      lambda run=run: run(qg, xg, vg, k), lambda plain=plain: plain(qg, xg, vg, k),
                      None, sweep_cmp(exact=True),
                      bound(n * d * 2 + n * 4 + bq * d * 4 + bq * width * 8, 2 * bq * n * d,
                            "bf16")))
    return cases


def probe_cases(torch, gen, randn, d: int = 384, shapes=((8, 64), (16, 4), (16, 64))):
    """K8 at the JAX package's IVF bench shape (nlist 2,048 x L 256 x D 384 =
    262,144 vectors): B=8 P=64 (a served request: 3 query variants padded
    to 8 rows), B=16 P=4 and P=64, in bf16 and int8 (``d`` and ``shapes``
    for another width). Probes are distinct random lists per query; the
    bound counts each distinct list once."""
    from financial_rag_tpu_torch.ops import ivf_probe

    dev = torch.device("cuda")
    nlist, L = 2048, 256
    cases = []
    for label in ("bf16", "int8"):
        v = randn(nlist * L, d)
        v = v / v.norm(dim=1, keepdim=True)
        live = (torch.rand(nlist * L, generator=gen, device=dev) > 0.1).float()
        if label == "int8":
            st, w = quantize_rows(torch, v)
            w = w * live
        else:
            st, w = v.to(torch.bfloat16), live
        st, w = st.view(nlist, L, d), w.view(nlist, L)
        esize, op = (1, "int8") if label == "int8" else (2, "bf16")
        for b, p in shapes:
            q = randn(b, d)
            q = (q / q.norm(dim=1, keepdim=True))
            q = quantize_rows(torch, q)[0] if label == "int8" else q.to(torch.bfloat16)
            probes = torch.rand(b, nlist, generator=gen, device=dev).argsort(dim=1)[:, :p]
            probes = probes.to(torch.int32).contiguous()
            lists = int(probes.unique().numel())
            moved = lists * L * (d * esize + 4) + b * p * L * 4 + b * d * esize + b * p * 4
            cases.append(("probe_scores", f"B={b},P={p},nlist={nlist},L={L},D={d},{label}",
                          lambda q=q, st=st, w=w, pr=probes: ivf_probe.probe_scores(q, st, w, pr),
                          lambda q=q, st=st, w=w, pr=probes: ivf_probe.probe_scores_plain(q, st, w, pr),
                          None, max_abs_cmp(1e-6 if label == "int8" else 1e-4),
                          bound(moved, 2 * b * p * L * d, op)))
    return cases


CAUSAL_SHAPES = ((1, 4096, (1100,), "bf16"), (1, 128, (60,), "bf16"),
                 (3, 1024, (0, 300, 1023), "bf16"), (1, 4096, (1100,), "f32"))
# K9 at heads of 128, B=1 S=4,096: Qwen2-1.5B's 12 query / 2 kv heads at
# the served answer prompt's pad and at pad 0 (its first case is the
# kernels line's ``d128``), Qwen2-7B's 28 / 4 and Llama-3-8B's 32 / 8 at pad 0
CAUSAL_128_CASES = (((12, 2, 128), ((1, 4096, (1100,), "bf16"), (1, 4096, (0,), "bf16"))),
                    ((28, 4, 128), ((1, 4096, (0,), "bf16"),)),
                    ((32, 8, 128), ((1, 4096, (0,), "bf16"),)))


def causal_cases(torch, F, randn, heads=(14, 2, 64), shapes=CAUSAL_SHAPES):
    """K9 at the decoder's prefill shapes (Qwen2-0.5B: 14 query heads and 2
    kv heads of 64): the answer-prompt bucket B=1 S=4,096 with 1,100
    padding rows, the query normaliser's S=128, a generate_many wave of 3
    rows with mixed pads, and LLM_DTYPE=float32; or at ``heads`` (query,
    kv, head_dim) and ``shapes`` (named ``causal_flash_prefill@head_dim``
    where head_dim is not 64). See causal_cmp for the tolerances; padding
    rows exactly 0. The bound counts only the causal pairs at or past
    pad_len. Library: SDPA (is_causal, enable_gqa) at pad 0, [B,H,S,D]
    views, a yardstick only."""
    from financial_rag_tpu_torch.ops import causal_flash as cf

    hq, hkv, d = heads
    name = "causal_flash_prefill" if d == 64 else f"causal_flash_prefill@{d}"
    cases = []
    for b, s, pads, label in shapes:
        dtype = torch.bfloat16 if label == "bf16" else torch.float32
        q = randn(b, s, hq * d, dtype=dtype)
        k, v = randn(b, s, hkv * d, dtype=dtype), randn(b, s, hkv * d, dtype=dtype)
        pad = torch.tensor(pads, dtype=torch.int32, device="cuda")
        pairs = sum((s - p) * (s - p + 1) // 2 for p in pads)
        esize = 2 if dtype == torch.bfloat16 else 4

        def sdpa(q=q, k=k, v=v, b=b, s=s):
            return F.scaled_dot_product_attention(
                q.view(b, s, hq, d).transpose(1, 2), k.view(b, s, hkv, d).transpose(1, 2),
                v.view(b, s, hkv, d).transpose(1, 2), is_causal=True, enable_gqa=True)

        def plain(q=q, k=k, v=v, p=pad):
            return cf.causal_flash_prefill_plain(q, k, v, p, num_q_heads=hq, num_kv_heads=hkv)

        # the control: the plain version with its first real key tile (64
        # keys at head_dim 64, 128 at 128) lost
        control = (lambda q=q, k=k, v=v, p=pad: plain(q, k, v, p + (64 if d == 64 else 128))) \
            if (s, dtype) == (4096, torch.bfloat16) else None
        cases.append((name, f"B={b},S={s},pads={list(pads)},heads={hq}/{hkv}x{d},{label}",
                      lambda q=q, k=k, v=v, p=pad: cf.causal_flash_prefill(
                          q, k, v, p, num_q_heads=hq, num_kv_heads=hkv),
                      plain, sdpa, causal_cmp(pads, hq, dtype == torch.bfloat16, control),
                      bound(2 * b * s * (hq + hkv) * d * esize + 4 * b, 4 * pairs * hq * d,
                            "bf16" if dtype == torch.bfloat16 else "f32")))
    return cases


class ThreeCallFFN:
    """K3's yardstick: ``F.linear`` -> ``F.gelu`` -> ``F.linear`` in bf16
    (cuBLAS, the [N,I] intermediate written to device memory). Three PyTorch
    calls, not one: it is timed as ``ffn_three_call_ms``, and K3's
    ``library_ms`` stays null."""

    def __init__(self, F, x, w1, b1, w2, b2):
        self.F = F
        self.args = (x, w1.t().contiguous(), b1, w2.t().contiguous(), b2)

    def __call__(self):
        x, w1t, b1, w2t, b2 = self.args
        return self.F.linear(self.F.gelu(self.F.linear(x, w1t, b1)), w2t, b2)


class TwoCallTopk:
    """K4's yardstick: ``torch.mm`` of the bf16 queries and corpus to f32
    (cuBLAS), then ``torch.topk``: an exact top-k, a superset of K4's
    contract, in two PyTorch calls with the [Bq, N] scores written to device
    memory. It is timed as ``topk_two_call_ms``, and K4's ``library_ms``
    stays null."""

    def __init__(self, torch, queries, corpus, k: int):
        self.torch = torch
        self.args = (queries.to(corpus.dtype), corpus.t(), k)

    def __call__(self):
        q, xt, k = self.args
        return self.torch.topk(self.torch.mm(q, xt, out_dtype=self.torch.float32), k, dim=1)


class TwoCallInt8Topk:
    """K5's yardstick at the int8 index's shapes: ``torch._int_mm`` of the
    int8 queries and corpus (cuBLASLt, int32 out; its shape rules want more
    than 16 query rows), the rows' weights applied, then ``torch.topk``: an
    exact top-k over the [Bq, N] scores written to device memory. Timed as
    ``topk_two_call_ms``; K5's ``library_ms`` stays null."""

    def __init__(self, torch, queries, corpus, valid, k: int):
        from financial_rag_tpu_torch.ops import topk

        self.torch = torch
        q8, _ = topk.quantize_queries(queries, corpus.dtype)
        self.args = (q8.contiguous(), corpus.t(), valid, k)

    def __call__(self):
        q8, xt, valid, k = self.args
        return self.torch.topk(self.torch._int_mm(q8, xt).float() * valid, k, dim=1)


class SdpaBackward:
    """The library yardstick of K10: SDPA's backward on the same inputs
    ([B,H,S,D] views, the bias as a bf16 mask), timed as forward+backward
    through torch.autograd.grad minus the forward alone."""

    def __init__(self, torch, F, q, k, v, bias, dout, heads: int):
        b, s, h = q.shape
        self.torch, self.F = torch, F

        def split(x):
            return x.view(b, s, heads, h // heads).transpose(1, 2)

        self.q, self.k, self.v = (split(x).detach().requires_grad_() for x in (q, k, v))
        self.mask = bias.to(torch.bfloat16)[:, None, None, :]
        self.dout = split(dout)
        self.shape = q.shape

    def forward(self):
        return self.F.scaled_dot_product_attention(self.q, self.k, self.v, attn_mask=self.mask)

    def __call__(self):
        out = self.forward()
        grads = self.torch.autograd.grad(out, (self.q, self.k, self.v), self.dout)
        return tuple(g.transpose(1, 2).reshape(self.shape) for g in grads)

    def ms(self, cuda_ms) -> float:
        return cuda_ms(self.torch, self) - cuda_ms(self.torch, self.forward)


# (B, S) of K10 at 12 heads of 32, then of 64 (the bge-base width: its
# contrastive encode, K2's table shape, a ragged S, the listwise step)
BWD_SHAPES = ((256, 128), (512, 128), (256, 64), (256, 32), (256, 512))
WIDE_BWD_SHAPES = ((256, 128), (256, 512), (256, 100), (256, 64))


def attention_bwd_cases(torch, F, randn, padded_mask, head_dim: int = 32, shapes=BWD_SHAPES):
    """K10 at the train path's shapes: B=256 S=128 (one encode of the
    contrastive step: its 256 queries and its 256 documents are two
    launches), B=512 S=128 (both encodes as one batch), B=256 S=64 (the
    listwise step: 64 groups x 4), B=256 S=32 (the retrieval uplift's
    training) and B=256 S=512 (K2's table shape). S=64 and S=32 are one
    key tile, the second partly filled. Padded rows of random length and
    one fully masked row. Each shape up to S=128 carries the mask-ignored
    control; every shape is launched twice and must give the same bits.
    The bound counts q, k, v, dO and the bias read once and dq, dk, dv
    written once, the five S x S x head_dim products of the gradient and
    one exponential a score (the probabilities recomputed), over the live
    keys only (a masked key adds exact zeros); a ``kernel_bound`` line gives
    each term and the live share of the pairs, since the kernel's header
    counts a full mask. At head_dim 64 (WIDE_BWD_SHAPES) the cases are
    named ``flash_attention_bwd@64``."""
    from financial_rag_tpu_torch.ops import flash_attention as fa

    NH, hd = 12, head_dim
    H = NH * hd
    name = "flash_attention_bwd" if hd == 32 else f"flash_attention_bwd@{hd}"
    heads_label = f"{NH}" if hd == 32 else f"{NH}x{hd}"
    cases = []
    for b, s in shapes:
        q, k, v, do = (randn(b, s, H, dtype=torch.bfloat16) for _ in range(4))
        mask = padded_mask(b, s, fully_masked_row=True)
        bias = torch.where(mask > 0, 0.0, -1e9).float()
        live_pairs = s * int(mask.sum().item()) + s * s   # the masked row's keys all count
        terms = (7 * b * s * H * 2 + b * s * 4, 5 * 2 * NH * hd * live_pairs, "bf16",
                 NH * live_pairs)
        path, kernels, smem = fa.bwd_launch_plan(s, hd)
        emit({"phase": "kernel_bound", "name": name, "shape": f"B={b},S={s},H={H}",
              "path": path, "kernels": list(kernels), "smem_bytes": smem,
              "live_share": live_pairs / (b * s * s), **bound_terms(*terms)})
        control = None
        if s <= 128 or hd == 64:
            control = (lambda q=q, k=k, v=v, do=do, b=b, s=s: fa.flash_attention_bwd(
                q, k, v, torch.zeros(b, s, device=q.device), do, num_heads=NH))
        run = (lambda q=q, k=k, v=v, bias=bias, do=do: fa.flash_attention_bwd(
            q, k, v, bias, do, num_heads=NH))
        cases.append((name, f"B={b},S={s},H={H},heads={heads_label},bf16", run,
                      lambda q=q, k=k, v=v, bias=bias, do=do: fa.flash_attention_bwd_plain(
                          q, k, v, bias, do, num_heads=NH),
                      SdpaBackward(torch, F, q, k, v, bias, do, NH),
                      with_path(attention_bwd_cmp(NH, control, again=run), name, f"B={b},S={s}",
                                path, kernels, probe=("bwd", b, s, H, NH) if hd == 64 else None),
                      bound(*terms)))
    return cases


def row_rel_err(got, want, heads: int) -> float:
    """Largest max|got - want| over one (position, head) row of a [B,S,H]
    gradient, as a share of max|want| over the same row; a row of exact
    zeros in ``want`` must be exact zeros in ``got``."""
    got, want = (t.float().reshape(-1, heads, t.shape[-1] // heads) for t in (got, want))
    err = (got - want).abs().amax(dim=-1)
    return (err / want.abs().amax(dim=-1)).masked_fill(err == 0, 0.0).max().item()


def attention_bwd_cmp(heads: int, control=None, again=None):
    """dq, dk and dv each within 2^-6 of every (position, head) row's
    largest value (two bf16 ulps of it), as K9's check; rows of exact zeros
    (masked keys' dk and dv) exactly zero. ``control``, the kernel run with
    the padding mask ignored, must fail the same bound. ``again``, a second
    launch on the same inputs, must give the same bits (K10 has no atomics)."""
    rtol = 2.0 ** -6

    def cmp(a, b):
        rels = {name: row_rel_err(x, y, heads) for name, x, y in zip(("dq", "dk", "dv"), a, b)}
        err = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
        detail = {"rtol": rtol, "max_row_rel_err": rels}
        ok = max(rels.values()) <= rtol
        if again is not None:
            detail["bit_identical_run_to_run"] = all(x.equal(y) for x, y in zip(again(), a))
            ok = ok and detail["bit_identical_run_to_run"]
        if control is not None:
            c = control()
            crel = {name: row_rel_err(x, y, heads) for name, x, y in zip(("dq", "dk", "dv"), c, b)}
            detail["control_mask_ignored_row_rel_err"] = crel
            ok = ok and max(crel.values()) > rtol
        return err, ok, detail
    return cmp


def causal_rel_err(a, b, pad: int, hq: int, first: int = 0) -> float:
    """Largest max|a - b| over one (position, head) output row of K9, as a
    share of max|b| over the same row, for rows at or past pad + first."""
    s = a.shape[0]
    a = a[pad + first:].float().view(s - pad - first, hq, -1)
    b = b[pad + first:].float().view(s - pad - first, hq, -1)
    diff = (a - b).abs().amax(dim=-1)
    return (diff / b.abs().amax(dim=-1).clamp_min(1e-30)).max().item()


def causal_cmp(pads, hq: int, bf16: bool, control=None):
    """Real rows (position >= pad_len) within an absolute tol (3e-2 bf16,
    1e-4 f32), and each (position, head) row within rtol of its own largest
    value (2^-6 bf16, two ulps of that value; 1e-4 f32): a row that attends
    n random keys has outputs of about sqrt(e/n), 0.03 at n = 3,000, as
    small as the absolute bound, which says little about such rows. Padding
    rows exactly 0. ``control`` (the plain version with the first real key tile lost) must
    fail the relative bound on the longest 1,024 rows, where that tile is
    2% (64 keys) or 4% (128 keys, head_dim 128) of the keys."""
    tol, rtol = (3e-2, 2.0 ** -6) if bf16 else (1e-4, 1e-4)

    def cmp(a, b):
        err, rel, pad_max = 0.0, 0.0, 0.0
        for row, p in enumerate(pads):
            err = max(err, (a[row, p:].float() - b[row, p:].float()).abs().max().item())
            rel = max(rel, causal_rel_err(a[row], b[row], p, hq))
            if p:
                pad_max = max(pad_max, a[row, :p].float().abs().max().item(),
                              b[row, :p].float().abs().max().item())
        detail = {"tol": tol, "rtol": rtol, "max_row_rel_err": rel,
                  "padding_rows_max_abs": pad_max}
        ok = err <= tol and rel <= rtol and pad_max == 0.0
        if control is not None:
            c, p, s = control(), pads[0], a.shape[1]
            tail = s - 1024 - p
            detail["control_tile_lost_longest_rows"] = {
                "max_abs_err": (c[0, s - 1024:].float() - b[0, s - 1024:].float()).abs().max().item(),
                "max_row_rel_err": causal_rel_err(c[0], b[0], p, hq, tail)}
            ok = ok and detail["control_tile_lost_longest_rows"]["max_row_rel_err"] > rtol
        return err, ok, detail
    return cmp


# the int8 / bf16 sweep each flat sweep must run on the card, and the older
# sweeps none of them may fall back to (profiler kernel names)
HOPPER_SWEEP = {"bucketed_topk": "bucketed_wgmma_sweep_kernel",
                "bucketed_topk_fused": "bucketed_wgmma_sweep_kernel",
                "topk_matmul": "exact_wgmma_sweep_kernel"}
OLDER_SWEEPS = ("bucketed_sweep_kernel", "exact_sweep_kernel")


PROFILE_ATTEMPTS = 3


def device_events(prof) -> list:
    """The device activities (kernels, copies) of one torch.profiler run,
    without the host's user annotations mirrored on the device timeline."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profiled(torch, fn, with_cpu: bool = False):
    """Runs fn(attempt) under torch.profiler; returns (profiler, fn's value).
    Now and then the profiler's trace of a call that launched kernels holds
    no device activity at all. Such a run tells nothing about which kernels
    ran, so it is made again, with the next attempt number, and the phase
    fails after PROFILE_ATTEMPTS empty traces. A trace that holds any device
    activity is returned as it is, for the caller's checks."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_cpu else [])
    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            value = fn(attempt)
            torch.cuda.synchronize()
        if device_events(prof):
            return prof, value
        print(f"chip_smoke: the profiler's trace held no device activity "
              f"(attempt {attempt + 1} of {PROFILE_ATTEMPTS}, {len(prof.events())} events)",
              file=sys.stderr, flush=True)
    raise SmokeFailure(f"the profiler saw no device activity in {PROFILE_ATTEMPTS} traces")


def cuda_kernel_names(torch, fn) -> list:
    """The names of the CUDA kernels one call of fn() launches, under
    torch.profiler."""
    prof, _ = profiled(torch, lambda attempt: fn())
    return sorted({e.name for e in device_events(prof)})


# One sweep case in a fresh process: random inputs of the case's shape and
# dtype (the wrapper picks its kernels by those alone), one call, then one
# profiled call; prints the device kernels' names as JSON.
FRESH_SWEEP_PROBE = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from financial_rag_tpu_torch.ops import topk
out = []
for name, bq, n, d, k, dtype in json.loads(sys.argv[1]):
    q = torch.randn(bq, d, device="cuda")
    if dtype == "int8":
        x = torch.randint(-127, 128, (n, d), device="cuda").to(torch.int8)
    else:
        x = torch.randn(n, d, device="cuda").to({"bf16": torch.bfloat16}.get(dtype, torch.float32))
    valid = torch.ones(n, device="cuda")
    getattr(topk, name)(q, x, valid, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        getattr(topk, name)(q, x, valid, k)
        torch.cuda.synchronize()
    out.append(sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA}))
print(json.dumps(out))
"""


def fresh_sweep_names(cases) -> list:
    """The kernel names torch.profiler records for each (wrapper, shape)
    case, made again in one fresh Python process. In some chip_smoke
    processes the profiler recorded no event of one sweep instantiation
    (bucketed_wgmma_sweep_kernel<bf16, 1, 768>) in any trace, while the
    kernel's results were right and fresh processes recorded it every
    time; a sweep missing from this process's trace is looked for there."""
    spec = []
    for name, shape in cases:
        m = re.match(r"Bq=(\d+),N=(\d+),D=(\d+),k=(\d+),(\w+)", shape)
        check(m is not None, f"no sweep shape in {shape!r}")
        spec.append([name, *(int(v) for v in m.groups()[:4]), m.group(5)])
    out = subprocess.run([sys.executable, "-c", FRESH_SWEEP_PROBE, json.dumps(spec)],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"the fresh sweep probe failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def max_abs_cmp(tol):
    def cmp(a, b):
        err = (a.float() - b.float()).abs().max().item()
        return err, err <= tol, {"tol": tol}
    return cmp


def phase_kernels(torch, F, seed):
    """Returns {kernel name: the entry of its first (main-path) shape}; a
    kernel's cases at another head width under ``name@head_dim``."""
    results = {}
    failures = []
    unseen = []   # (name, shape, names): a trace without the Hopper sweep nor an older one
    for name, shape, run, plain, library, cmp, (bound_ms, bound_by) in kernel_cases(torch, F, seed):
        kernel, _, head_dim = name.partition("@")
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        err, ok, detail = cmp(out, ref)
        if name in HOPPER_SWEEP:
            names = cuda_kernel_names(torch, run)
            detail["sweep_kernels"] = [n for n in names if "sweep" in n]
            if any(old in n for n in names for old in OLDER_SWEEPS):
                failures.append(f"{name} [{shape}] did not run {HOPPER_SWEEP[name]} alone: "
                                f"{names}")
            elif not any(HOPPER_SWEEP[name] in n for n in names):
                unseen.append((name, shape, names))
        ms = cuda_ms(torch, run)
        if kernel == "causal_flash_prefill":   # the kernel alone, without the wrapper's host time
            detail["device_ms"] = device_ms(torch, run)
        plain_ms = cuda_ms(torch, plain)
        if isinstance(library, SdpaBackward):
            lib_ms = library.ms(cuda_ms)
            # without the fully masked last row: SDPA's log-sum-exp of scores
            # all near -1e9 loses log(S) in f32, so its P there sums to S
            detail["library_max_abs_err_real_rows"] = max(
                (x[:-1].float() - y[:-1].float()).abs().max().item()
                for x, y in zip(library(), out))
        elif isinstance(library, ThreeCallFFN):
            lib_ms = None
            detail["ffn_three_call_ms"] = cuda_ms(torch, library)
            detail["ffn_three_call_max_abs_err"] = (library().float() - out.float()).abs().max().item()
        elif isinstance(library, (TwoCallTopk, TwoCallInt8Topk)):
            lib_ms = None
            detail["topk_two_call_ms"] = cuda_ms(torch, library)
        else:
            lib_ms = cuda_ms(torch, library) if library is not None else None
        if library is not None and kernel not in ("causal_flash_prefill", "flash_attention_bwd",
                                                "fused_ffn", "packed_topk_fused",
                                                "bucketed_topk_fused", "topk_matmul"):
            # K9's SDPA is at pad 0; K10's is compared above
            lib_err = (library().transpose(1, 2).reshape(out.shape).float() - out.float()
                       ).abs().max().item()
            detail["library_max_abs_err"] = lib_err
        entry = {"phase": "kernel", "name": kernel, "shape": shape, "max_abs_err": err, "ok": ok,
                 "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, **detail}
        if head_dim:
            entry["head_dim"] = int(head_dim)
        emit(entry)
        if not ok:
            failures.append(f"{name} [{shape}]: {detail} max_abs_err={err}")
        if name not in results:       # the first case of each kernel is its largest shape
            results[name] = entry
        else:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        del out, ref
        torch.cuda.empty_cache()
    if PATH_CHECKS:   # the attention paths at heads of 64, in one fresh process
        fresh = fresh_path_names([[*probe, list(kernels)] for *_, probe, kernels in PATH_CHECKS])
        for (name, shape, path, probe, kernels), names in zip(PATH_CHECKS, fresh):
            ran = path_ran(names, kernels)
            emit({"phase": "kernel_path", "name": name, "shape": shape, "path": path,
                  "kernels_run": [n for n in names if "attn_" in n], "path_ran": ran})
            if not ran:
                failures.append(f"{name} [{shape}]: the path {path} did not run: {names}")
    if unseen:
        print(f"chip_smoke: the profiler's trace held no Hopper sweep in {len(unseen)} cases; "
              "looking for it in a fresh process", file=sys.stderr, flush=True)
        fresh = fresh_sweep_names([(name, shape) for name, shape, _ in unseen])
        for (name, shape, names), again in zip(unseen, fresh):
            emit({"phase": "kernel_sweep_fresh", "name": name, "shape": shape,
                  "sweep_kernels": [n for n in again if "sweep" in n]})
            if not any(HOPPER_SWEEP[name] in n for n in again) or any(
                    old in n for n in again for old in OLDER_SWEEPS):
                failures.append(f"{name} [{shape}] did not run {HOPPER_SWEEP[name]} alone: "
                                f"{names}; in a fresh process: {again}")
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


def write_safetensors(path: Path, tensors: dict) -> None:
    """A ``.safetensors`` file (8-byte header length, JSON header, raw
    little-endian bytes) from torch tensors: the GPU machine has no
    ``safetensors`` package."""
    import torch

    codes = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


CHATML_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")


def write_wordlevel_tokenizer(dest: Path, words, vocab_size: int) -> int:
    """tokenizer.json (WordLevel over ``words``, the numerals 0-99 and
    <unk>, padded with w{i} up to ``vocab_size`` so that every model id
    decodes to a word; Whitespace pre-tokenizer; the ChatML markers as
    special added tokens) and a ChatML tokenizer_config.json, as the
    ``tokenizers`` package writes them. Returns the eos id (<|im_end|>)."""
    vocab = {}
    for w in ["<unk>", *CHATML_SPECIALS, *sorted(set(words)), *map(str, range(100))]:
        vocab.setdefault(w, len(vocab))
    for i in range(len(vocab), vocab_size):
        vocab[f"w{i}"] = i
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True} for t in CHATML_SPECIALS]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    (dest / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (dest / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": "{% for m in messages %}<|im_start|>{{ m.role }}\n"
                         "{{ m.content }}<|im_end|>\n{% endfor %}"}))
    return vocab["<|im_end|>"]


def prompt_words():
    """The words of the golden and filler corpora and of the prompt
    templates, as the Whitespace pre-tokenizer splits them."""
    import re

    from financial_rag_tpu_torch.llm.prompts import QUERY_NORMALIZE, build_answer_prompt

    text = " ".join([*GOLDEN_CORPUS.values(), *FILLER_WORDS, *GOLDEN_QUESTIONS, QUERY_NORMALIZE,
                     build_answer_prompt("q", [{"content": "c"}], ["r"]), "user assistant"])
    return re.findall(r"\w+|[^\w\s]+", text)


# the committed byte-level BPE tokenizer of the Qwen2 family (written by
# tests/data/bpe/make_fixtures.py with the tokenizers package)
BPE_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "bpe" / "qwen2_style"


def write_bpe_tokenizer(dest: Path, fixture: Path, vocab_size: int) -> int:
    """The fixture's tokenizer.json with its vocabulary padded to
    ``vocab_size`` ids by tokens that no merge reaches (``Ġw{id}``: encoding
    is unchanged, and every id a random-weight model emits decodes to a
    word), and its tokenizer_config.json. Returns the eos id (<|im_end|>)."""
    spec = json.loads((fixture / "tokenizer.json").read_text(encoding="utf-8"))
    vocab = spec["model"]["vocab"]
    taken = set(vocab.values()) | {t["id"] for t in spec["added_tokens"]}
    for i in range(vocab_size):
        if i not in taken:
            check(f"Ġw{i}" not in vocab, f"padding token Ġw{i} is in the fixture's vocabulary")
            vocab[f"Ġw{i}"] = i
    (dest / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    shutil.copy(fixture / "tokenizer_config.json", dest / "tokenizer_config.json")
    return next(t["id"] for t in spec["added_tokens"] if t["content"] == "<|im_end|>")


def write_llm_checkpoint(dest: Path, hf: dict, seed: int, device="cuda",
                         bpe_fixture: Path | None = None) -> int:
    """A seeded random-weight Qwen2/Llama checkpoint in HF layout: config.json,
    a bf16 model.safetensors (normal(0.02) matrices and biases, unit norms,
    the HF initialisation) and the WordLevel tokenizer, or ``bpe_fixture``'s
    tokenizer padded to the vocabulary. Returns the eos id."""
    import torch

    dest.mkdir(parents=True, exist_ok=True)
    if bpe_fixture is None:
        eos = write_wordlevel_tokenizer(dest, prompt_words(), hf["vocab_size"])
    else:
        eos = write_bpe_tokenizer(dest, bpe_fixture, hf["vocab_size"])
    hf = {**hf, "eos_token_id": eos, "bos_token_id": eos}
    (dest / "config.json").write_text(json.dumps(hf))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, ff = hf["hidden_size"], hf["intermediate_size"]
    kv = hf["num_key_value_heads"] * (h // hf["num_attention_heads"])

    def normal(*shape):
        return (torch.randn(*shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    sd = {"model.embed_tokens.weight": normal(hf["vocab_size"], h)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": ones(h),
                   p + "self_attn.q_proj.weight": normal(h, h), p + "self_attn.q_proj.bias": normal(h),
                   p + "self_attn.k_proj.weight": normal(kv, h), p + "self_attn.k_proj.bias": normal(kv),
                   p + "self_attn.v_proj.weight": normal(kv, h), p + "self_attn.v_proj.bias": normal(kv),
                   p + "self_attn.o_proj.weight": normal(h, h),
                   p + "post_attention_layernorm.weight": ones(h),
                   p + "mlp.gate_proj.weight": normal(ff, h), p + "mlp.up_proj.weight": normal(ff, h),
                   p + "mlp.down_proj.weight": normal(h, ff)})
    sd["model.norm.weight"] = ones(h)
    if not hf.get("tie_word_embeddings", False):
        sd["lm_head.weight"] = normal(hf["vocab_size"], h)
    write_safetensors(dest / "model.safetensors", sd)
    return eos


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


def write_corpus(work: Path, seed: int):
    """The golden documents and 22 seeded filler documents as Marker JSON;
    returns [(path, doc_id)]."""
    import numpy as np

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
    return items


def ingest_all(rt, items):
    t_ingest = time.perf_counter()
    results = rt.pipeline.ingest_paths(items)
    rt.pipeline.flush()
    ingest_s = time.perf_counter() - t_ingest
    errors = [r for r in results if r is None or "error" in r]
    check(not errors, f"ingest errors: {errors[:3]}")
    children = sum(r["children"] for r in results)
    check(children >= MIN_CHILDREN, f"only {children} children ingested")
    check(all(i.count() == children for i in rt.indexes.values()), "index counts differ")
    return children, ingest_s


def golden_queries(rt, what: str):
    """The 9 golden questions through RAGEngine.query: each must succeed with
    children, none from the result cache, and the rerank must reach the
    cross-encoder without falling back. Returns (query ms, answers)."""
    methods = []
    rerank = rt.engine.reranker.rerank_chunks

    def recording_rerank(*a, **kw):
        out = rerank(*a, **kw)
        methods.extend(c.get("normalization_method") for c in out)
        return out

    rt.engine.reranker.rerank_chunks = recording_rerank
    query_ms, answers = [], []
    try:
        for question in GOLDEN_QUESTIONS:
            tq = time.perf_counter()
            out = rt.engine.query(question)
            query_ms.append((time.perf_counter() - tq) * 1e3)
            check(out.get("success") is True,
                  f"{what}: query failed: {question!r}: {out.get('answer')}")
            check(out["top_children_chunks"], f"{what}: no children for {question!r}")
            check(not out.get("cache_hit"), f"{what}: {question!r} came from the result cache")
            answers.append(out)
    finally:
        rt.engine.reranker.rerank_chunks = rerank
    check("fallback-uniform" not in methods, f"{what}: the rerank fell back to uniform scores")
    check(any(m in CROSS_ENCODER_METHODS for m in methods),
          f"{what}: no query reached the cross-encoder")
    return query_ms, answers, sorted({str(m) for m in methods})


def phase_slice(torch, seed, work: Path):
    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.models.encoder import Encoder
    from financial_rag_tpu_torch.runtime import Runtime

    t0 = time.perf_counter()
    paths = write_checkpoints(work / "models", seed)
    os.environ["EMBED_BAAI_PATH"] = str(paths["bge-small"])
    os.environ["EMBED_GTE_PATH"] = str(paths["gte-small"])
    os.environ["CROSS_ENCODER_PATH"] = str(paths["minilm-l6-ce"])
    cfg = FrameworkConfig.from_env()
    cfg.llm.gemini_api_key = None              # NullLLM: no network
    checkpoints_s = time.perf_counter() - t0
    items = write_corpus(work, seed)

    reset_launches()
    t_build = time.perf_counter()
    rt = Runtime.build(cfg, data_dir=work / "data", device="cuda")
    build_s = time.perf_counter() - t_build
    # the default config wraps each device-backed encoder in a BatchingEncoder
    check(all(isinstance(getattr(e, "inner", None), Encoder)
              for e in rt.dual_encoder.encoders.values()),
          "an encoder fell back to the lexical HashingEncoder or has no BatchingEncoder")
    check(rt.engine.reranker.model is not None, "the cross-encoder did not load")
    check(all(i.backend == "pallas_fused" for i in rt.indexes.values()),
          "an index is not on the packed sweep")

    children, ingest_s = ingest_all(rt, items)
    ingest_launches = read_launches()
    query_ms, answers, methods = golden_queries(rt, "flat bf16")
    launches = read_launches()
    check_path_launched(FLAT_PATH, launches, "flat bf16 path")
    query_launches = {name: launches[name] - ingest_launches[name] for name in launches}
    check_path_launched(FLAT_PATH, query_launches, "flat bf16 query path")

    emit({"phase": "slice", "children": children, "documents": len(items),
          "index_capacity": rt.indexes["baai"].capacity,
          "checkpoints_s": round(checkpoints_s, 3), "runtime_build_s": round(build_s, 3),
          "ingest_s": round(ingest_s, 3), "children_per_s": round(children / ingest_s, 1),
          "query_p50_ms": round(statistics.median(query_ms), 3),
          "query_max_ms": round(max(query_ms), 3), "queries": len(query_ms),
          "reranked_methods": methods,
          "launches": launches, "launches_ingest": ingest_launches,
          "launches_queries": query_launches})
    texts = [c["text"] for out in answers for c in out["top_children_chunks"]]
    served = {"children": children, "answers": answers, "query_launches": query_launches,
              "query_p50_ms": statistics.median(query_ms),
              "children_per_s": children / ingest_s}
    return rt, cfg, paths, items, launches, texts, served


def phase_ivf(torch, cfg, work: Path, items):
    """INDEX_KIND=ivf with the defaults otherwise: planned capacity 131,072
    -> nlist 1,024, list_size 256, nprobe 64 (config.py, runtime.py)."""
    from financial_rag_tpu_torch.index.ivf import IVFIndex
    from financial_rag_tpu_torch.runtime import Runtime

    cfg = copy.deepcopy(cfg)
    cfg.index.kind = "ivf"
    cfg.index.ivf_autotune_recall = 0.9
    cfg.index.ivf_autotune_sample = 32
    reset_launches()
    t_build = time.perf_counter()
    rt = Runtime.build(cfg, data_dir=work / "data_ivf", device="cuda")
    build_s = time.perf_counter() - t_build
    check(all(isinstance(i, IVFIndex) and i.device.type == "cuda" for i in rt.indexes.values()),
          "an index is not an IVF index on the card")
    shape = {n: (i.nlist, i.list_size, i.nprobe) for n, i in rt.indexes.items()}
    check(all(v == (1024, 256, 64) for v in shape.values()), f"IVF shape {shape}")
    children, ingest_s = ingest_all(rt, items)
    ingest_launches = read_launches()
    query_ms, _, methods = golden_queries(rt, "ivf")
    launches = read_launches()
    query_launches = {name: launches[name] - ingest_launches[name] for name in launches}
    check_path_launched(IVF_PATH, launches, "ivf path")
    check(query_launches["probe_scores"] > 0, f"ivf: probe_scores not on the query path "
                                              f"({query_launches})")
    before = launches["probe_scores"]
    t_tune = time.perf_counter()
    reports = rt.tune_indexes()
    tune_s = time.perf_counter() - t_tune
    check(set(reports) == set(rt.indexes), f"tune_indexes reported {sorted(reports)}")
    tune_launches = read_launches()["probe_scores"] - before
    emit({"phase": "ivf", "children": children, "ivf_shape": shape,
          "lists_used": {n: int((i._fill > 0).sum()) for n, i in rt.indexes.items()},
          "max_list_fill": {n: int(i._fill.max()) for n, i in rt.indexes.items()},
          "runtime_build_s": round(build_s, 3), "ingest_s": round(ingest_s, 3),
          "children_per_s": round(children / ingest_s, 1),
          "query_p50_ms": round(statistics.median(query_ms), 3),
          "query_max_ms": round(max(query_ms), 3), "queries": len(query_ms),
          "reranked_methods": methods, "launches": launches,
          "launches_ingest": ingest_launches, "launches_queries": query_launches,
          "tune_s": round(tune_s, 3), "tune_probe_launches": tune_launches,
          "tuning": {n: {k: r[k] for k in ("nprobe", "target_met", "recall_min", "queries",
                                           "sweep", "query_source")}
                     for n, r in reports.items()}})
    return rt, launches


def phase_int8(torch, rt, cfg, work: Path):
    """The restart path: the bf16 runtime's indexes saved, its data dir
    copied (without the feedback DB, whose result cache would answer the
    questions), and Runtime.build there with INDEX_DTYPE=int8."""
    from financial_rag_tpu_torch.runtime import Runtime

    rt.save_indexes(work / "data")
    shutil.copytree(work / "data", work / "data_int8",
                    ignore=shutil.ignore_patterns("feedback.db*"))
    cfg = copy.deepcopy(cfg)
    cfg.index.dtype = "int8"
    reset_launches()
    rt8 = Runtime.build(cfg, data_dir=work / "data_int8", device="cuda")
    check(all(i.dtype == torch.int8 and i.backend == "pallas_fused" and i.count() > 0
              for i in rt8.indexes.values()), "the int8 runtime did not reload int8 indexes")
    query_ms, _, methods = golden_queries(rt8, "int8")
    launches = read_launches()
    check_path_launched(INT8_PATH, launches, "int8 path")
    emit({"phase": "int8", "reloaded": {n: i.count() for n, i in rt8.indexes.items()},
          "query_p50_ms": round(statistics.median(query_ms), 3),
          "query_max_ms": round(max(query_ms), 3), "reranked_methods": methods,
          "launches": launches})
    return launches


SHARDS = 4               # INDEX_SHARDS of the sharded phase (all on the one card)
SHARD_ENCODE_DP = 2      # ENCODE_DP of the sharded phase
SHARD_TIE = 2.0 ** -7    # consecutive final scores this close are a tie
SHARD_DENSE_TIE = 1e-5   # index scores this close are a tie (K4 keeps ~2^-20 of them)
DP_COS_MIN = 0.9999      # data-parallel against one-device embeddings
SHARDED_PATH = ("masked_mean_l2_normalize", "flash_attention", "fused_ffn", "bucketed_topk")
SHARDED_IVF_PATH = IVF_PATH
# index classes at scale: (dtype, D, rows a shard); 4 shards each, k 24
SHARD_SCALE = (("bfloat16", 384, 262144), ("int8", 384, 262144), ("bfloat16", 768, 131072))
SHARD_SCALE_BQ = (8, 128)
SHARD_K = 24
# the sharded IVF at scale: the 10M-chunk configuration cut to 4 x 262,144 rows
SHARD_IVF = {"rows": 262144, "nlist": 1024, "nprobe": 64, "list_size": 512, "centers": 4096}


def count_searches(rt) -> dict:
    """Wrap every index's ``search`` to count its calls: {model: count}."""
    counts = {}
    for name, idx in rt.indexes.items():
        counts[name] = 0
        inner = idx.search

        def counted(*a, _inner=inner, _name=name, **kw):
            counts[_name] += 1
            return _inner(*a, **kw)

        idx.search = counted
    return counts


def record_searches(rt) -> dict:
    """Wrap every index's ``search`` to keep each call's (queries, ids,
    scores): {model: [call, ...]}."""
    import numpy as np

    calls = {}
    for name, idx in rt.indexes.items():
        calls[name] = []
        inner = idx.search

        def recorded(queries, *a, _inner=inner, _name=name, **kw):
            ids, scores = _inner(queries, *a, **kw)
            calls[_name].append((np.array(queries, np.float32, ndmin=2), ids, scores))
            return ids, scores

        idx.search = recorded
    return calls


def child_key(c: dict):
    return (c.get("document_name"), c.get("text"))


def child_score(c: dict) -> float:
    return float(c["final_rerank_score"] if c.get("final_rerank_score") is not None
                 else c["retrieval_score"])


def same_top_children(got: list, want: list, tol: float = SHARD_TIE):
    """The sharded runtime's top children against the single-device
    runtime's (reported): want's children split where consecutive final
    scores differ by more than
    ``tol``; each group must hold the same children at the same positions
    in got, in any order within the group. A group that reaches the end of
    the list may be cut by the top-n: there, a child of got's that is not in
    want's group must tie with it. Returns None, or what differs."""
    if len(got) != len(want):
        return f"{len(got)} children against {len(want)}"
    lo = 0
    for i in range(1, len(want) + 1):
        if i < len(want) and child_score(want[i - 1]) - child_score(want[i]) <= tol:
            continue
        g, w = got[lo:i], want[lo:i]
        if {child_key(c) for c in g} != {child_key(c) for c in w}:
            tail = i == len(want) and all(
                abs(child_score(c) - child_score(w[-1])) <= tol
                for c in g if child_key(c) not in {child_key(x) for x in w})
            if not tail:
                return f"positions {lo}-{i - 1}: {[child_key(c)[1][:40] for c in g]} " \
                       f"against {[child_key(c)[1][:40] for c in w]}"
        lo = i
    return None


def dp_cosine(torch, single_enc, dp_enc, texts) -> float:
    """Least cosine of the data-parallel encoder's embeddings against the
    one-device encoder's, on the same texts."""
    import numpy as np

    a, b = dp_enc.encode(texts), single_enc.encode(texts)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return float(cos.min())


def same_ranking(got_ids, got_s, want_ids, want_s, tol: float = SHARD_DENSE_TIE):
    """One query's top k against the single-device index's: want's list
    split where consecutive scores differ by more than ``tol``; each group
    must hold the same ids at the same positions in got, in any order
    within the group, with scores within ``tol``; in a group that the k cut,
    an id of got's that is not in want's must tie with it. Returns None, or
    what differs."""
    import numpy as np

    if np.abs(np.asarray(got_s) - np.asarray(want_s)).max() > tol:
        return f"scores differ by {np.abs(np.asarray(got_s) - np.asarray(want_s)).max()}"
    k, lo = len(want_ids), 0
    for i in range(1, k + 1):
        if i < k and want_s[i - 1] - want_s[i] <= tol:
            continue
        g, w = set(got_ids[lo:i].tolist()), set(want_ids[lo:i].tolist())
        if g != w and not (i == k and all(abs(s - want_s[k - 1]) <= tol
                                          for s in got_s[lo:i])):
            return f"positions {lo}-{i - 1}: {sorted(g)} against {sorted(w)}"
        lo = i
    return None


def phase_sharded(torch, cfg, work: Path, items, rt_single, served: dict, texts):
    """Multi-GPU serving on the one card (every shard and replica on
    cuda:0). First the gate: Runtime.build with INDEX_SHARDS=4 and one
    encode replica on a copy of phase 4's data dir, which reloads phase 4's
    flat checkpoints into 4-shard ShardedFlatIndexes (so ids, rows and query
    vectors are phase 4's and only the index differs), answers the 9 golden
    questions; every dense search it made must give phase 4's index's top k
    on the same query vector (ids as sets within score ties of 1e-5), and
    each question whose top children differ from phase 4's (outside ties of
    2^-7 of the final scores) must have had a dense top k reordered within
    such a tie. Then INDEX_SHARDS=4 with ENCODE_DP=2, flat bf16, the
    slice's checkpoints and NullLLM: ingest, the 9 golden questions (K7 once
    a shard and a search, K4 and K5 never, K1-K3 on both replicas), the DP
    encoder against the one-device encoder; its top children against phase
    4's are reported (the DP encode's bf16 differences on these nearly
    parallel embeddings move the dense scores by ~1e-4). Then INDEX_KIND=ivf
    on 4 shards: ingest, tune_indexes, the 9 questions, K8 on every shard.
    Returns the DP runtime's query launches and the IVF path's launches."""
    import numpy as np

    from financial_rag_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex
    from financial_rag_tpu_torch.runtime import Runtime

    # the gate: phase 4's data dir (its flat checkpoints, documents and
    # children; not its result cache) reloaded with INDEX_SHARDS=4 and one
    # encode replica, so ids, rows and query vectors are phase 4's and only
    # the index differs
    shutil.copytree(work / "data", work / "data_sharded_gate",
                    ignore=shutil.ignore_patterns("feedback.db*"))
    cfg = copy.deepcopy(cfg)
    cfg.mesh.index_shards = SHARDS
    cfg.mesh.encode_dp = 1
    rt = Runtime.build(cfg, data_dir=work / "data_sharded_gate", device="cuda")
    check(all(isinstance(i, ShardedFlatIndex) and i.n_shards == SHARDS
              and i.backend == "pallas_bucketed" and i.count() == rt_single.indexes[n].count()
              for n, i in rt.indexes.items()),
          "sharded gate: phase 4's indexes did not reload into 4-shard K7 indexes")
    calls = record_searches(rt)
    _, gate_answers, _ = golden_queries(rt, "sharded gate")
    dense, dense_diffs, reordered = {}, {}, {}
    for name, seen in calls.items():
        check(len(seen) == len(GOLDEN_QUESTIONS) and all(q.shape[0] == 1 for q, _, _ in seen),
              f"sharded gate: {name}: {len(seen)} searches, not one a question")
        in_order, score_diff = [], 0.0
        for i, (qv, got_ids, got_s) in enumerate(seen):
            want_ids, want_s = rt_single.indexes[name].search(qv, got_ids.shape[1])
            diff = same_ranking(got_ids[0], got_s[0], want_ids[0], want_s[0])
            if diff:
                dense_diffs[f"{name}/{i}"] = diff
            if not (got_ids == want_ids).all():
                reordered.setdefault(i, []).append(name)
            in_order.append((got_ids == want_ids).mean())
            score_diff = max(score_diff, float(np.abs(got_s - want_s).max()))
        dense[name] = {"same_ids_in_order": float(np.mean(in_order)),
                       "max_score_diff": score_diff}
    check(not dense_diffs, f"sharded gate: dense top k differ from phase 4's index: {dense_diffs}")
    gate_final = {i: same_top_children(got["top_children_chunks"], want["top_children_chunks"])
                  for i, (got, want) in enumerate(zip(gate_answers, served["answers"]))}
    untraced = {GOLDEN_QUESTIONS[i]: d for i, d in gate_final.items()
                if d and i not in reordered}
    check(not untraced, f"sharded gate: top children differ where no dense top k moved "
                        f"within a tie: {untraced}")
    emit({"phase": "sharded_gate", "shards": SHARDS, "encode_dp": 1,
          "rows": {n: i.count() for n, i in rt.indexes.items()},
          "dense_vs_flat": dense,
          "dense_in_other_order_within_ties": {GOLDEN_QUESTIONS[i]: m
                                               for i, m in reordered.items()},
          "final_top_children_as_flat": sum(v is None for v in gate_final.values()),
          "final_differences": {GOLDEN_QUESTIONS[i]: d for i, d in gate_final.items() if d}})
    del rt
    torch.cuda.empty_cache()

    cfg.mesh.encode_dp = SHARD_ENCODE_DP
    reset_launches()
    t_build = time.perf_counter()
    rt = Runtime.build(cfg, data_dir=work / "data_sharded", device="cuda")
    build_s = time.perf_counter() - t_build
    check(all(isinstance(i, ShardedFlatIndex) and i.n_shards == SHARDS
              and i.backend == "pallas_bucketed" and i.dtype == torch.bfloat16
              and all(d.type == "cuda" for d in i.devices) for i in rt.indexes.values()),
          "sharded: the indexes are not 4-shard bf16 K7 indexes on the card")
    encs = {n: getattr(e, "inner", e) for n, e in rt.dual_encoder.encoders.items()}
    check(all(e.n_replicas == SHARD_ENCODE_DP for e in encs.values()),
          "sharded: the encoders are not data-parallel")
    children, ingest_s = ingest_all(rt, items)
    ingest_launches = read_launches()
    searches = count_searches(rt)
    query_ms, answers, methods = golden_queries(rt, "sharded")
    launches = read_launches()
    query_launches = {name: launches[name] - ingest_launches[name] for name in launches}
    check_path_launched(SHARDED_PATH, query_launches, "sharded query path")
    n_search = sum(searches.values())
    check(query_launches["bucketed_topk"] == SHARDS * n_search,
          f"sharded: K7 launched {query_launches['bucketed_topk']} times for {n_search} "
          f"searches of {SHARDS} shards")
    check(launches["packed_topk_fused"] == 0 and launches["bucketed_topk_fused"] == 0,
          f"sharded: K4 or K5 launched ({launches})")
    final = {q: same_top_children(got["top_children_chunks"], want["top_children_chunks"])
             for q, got, want in zip(GOLDEN_QUESTIONS, answers, served["answers"])}
    cos = {n: dp_cosine(torch, getattr(rt_single.dual_encoder.encoders[n], "inner",
                                       rt_single.dual_encoder.encoders[n]), e, texts[:64])
           for n, e in encs.items()}
    check(min(cos.values()) >= DP_COS_MIN, f"sharded: DP encode cosine {cos} < {DP_COS_MIN}")
    emit({"phase": "sharded", "shards": SHARDS, "encode_dp": SHARD_ENCODE_DP,
          "children": children, "runtime_build_s": round(build_s, 3),
          "ingest_s": round(ingest_s, 3), "children_per_s": round(children / ingest_s, 1),
          "flat_children_per_s": round(served["children_per_s"], 1),
          "query_p50_ms": round(statistics.median(query_ms), 3),
          "query_max_ms": round(max(query_ms), 3),
          "flat_query_p50_ms": round(served["query_p50_ms"], 3),
          "searches": searches, "reranked_methods": methods,
          "dp_cosine_min": cos,
          "final_top_children_as_flat": sum(v is None for v in final.values()),
          "final_differences": {q: v for q, v in final.items() if v},
          "cap_per_shard": rt.indexes["baai"].cap_per_shard,
          "launches": launches, "launches_ingest": ingest_launches,
          "launches_queries": query_launches})
    del rt
    torch.cuda.empty_cache()

    cfg.index.kind = "ivf"
    cfg.index.ivf_autotune_recall = 0.9
    cfg.index.ivf_autotune_sample = 32
    reset_launches()
    rt = Runtime.build(cfg, data_dir=work / "data_sharded_ivf", device="cuda")
    check(all(isinstance(i, ShardedIVFIndex) and i.n_shards == SHARDS
              and all(s.device.type == "cuda" for s in i.shards) for i in rt.indexes.values()),
          "sharded ivf: the indexes are not 4-shard IVF indexes on the card")
    children, ingest_s = ingest_all(rt, items)
    shape = {n: (i.nlist, i.shards[0].list_size, i.nprobe) for n, i in rt.indexes.items()}
    t_tune = time.perf_counter()
    reports = rt.tune_indexes()
    tune_s = time.perf_counter() - t_tune
    check(set(reports) == set(rt.indexes), f"sharded ivf: tune_indexes reported {sorted(reports)}")
    check(all(all(s.nprobe == i.nprobe for s in i.shards) for i in rt.indexes.values()),
          "sharded ivf: the tuned nprobe is not on every shard")
    per_shard = {}
    for name, idx in rt.indexes.items():
        for i, shard in enumerate(idx.shards):
            per_shard[(name, i)] = 0
            inner = shard.search_begin

            def counted(*a, _inner=inner, _key=(name, i), **kw):
                per_shard[_key] += 1
                return _inner(*a, **kw)

            shard.search_begin = counted
    before = read_launches()
    query_ms_ivf, _, methods_ivf = golden_queries(rt, "sharded ivf")
    launches_ivf = read_launches()
    k8 = launches_ivf["probe_scores"] - before["probe_scores"]
    check_path_launched(SHARDED_IVF_PATH, launches_ivf, "sharded ivf path")
    check(min(per_shard.values()) > 0 and k8 >= sum(per_shard.values()),
          f"sharded ivf: K8 not launched on every shard ({per_shard}, {k8} launches)")
    emit({"phase": "sharded_ivf", "shards": SHARDS, "children": children,
          "ivf_shape": shape, "ingest_s": round(ingest_s, 3),
          "children_per_s": round(children / ingest_s, 1),
          "query_p50_ms": round(statistics.median(query_ms_ivf), 3),
          "query_max_ms": round(max(query_ms_ivf), 3), "reranked_methods": methods_ivf,
          "tune_s": round(tune_s, 3),
          "tuned_nprobe": {n: r["nprobe"] for n, r in reports.items()},
          "shard_searches": {f"{n}/{i}": c for (n, i), c in per_shard.items()},
          "probe_launches_queries": k8, "launches": launches_ivf})
    return query_launches, launches_ivf


def fill_sharded(torch, idx, rows: int, gen) -> None:
    """``rows`` rows a shard, written on the card in place where upsert
    would put ids 1..rows x n_shards (round robin: id j + 1 at local slot
    j // n of shard j % n): 1/64-grid coordinates (small integers beside a
    weight of 1/64 for int8), so every score is exact. Making and
    normalising a million rows on the host would take longer than the
    searches."""
    import numpy as np

    n = idx.n_shards
    for s, shard in enumerate(idx.shards):
        if idx.dtype == torch.int8:
            shard._vectors[:rows] = torch.randint(-3, 4, (rows, idx.dim), generator=gen,
                                                  device="cuda").to(torch.int8)
            shard._valid[:rows] = 1.0 / 64
        else:
            shard._vectors[:rows] = (torch.randint(-3, 4, (rows, idx.dim), generator=gen,
                                                   device="cuda").float() / 64).to(idx.dtype)
            shard._valid[:rows] = 1.0
        ids = np.arange(rows) * n + s + 1
        shard._ids[:rows] = ids
        shard._slot_of = dict(zip(ids.tolist(), range(rows)))
        shard._next_slot = rows
    idx._owner = dict(zip(range(1, rows * n + 1), (np.arange(rows * n) % n).tolist()))
    idx._fill[:] = rows


def plain_sharded(torch, idx, q, k: int):
    """The plain composition: K7's plain version on each shard (on the
    card), then the index's merge and id map."""
    from financial_rag_tpu_torch.ops import topk
    from financial_rag_tpu_torch.parallel.sharded_index import merge_shards

    qt = torch.from_numpy(q).cuda()
    parts = [topk.bucketed_topk_plain(qt, s._vectors, s._valid, k, nbuckets=idx.nbuckets)
             for s in idx.shards]
    return merge_shards(parts, [s._ids for s in idx.shards], k)


def phase_sharded_scale(torch, seed: int):
    """The index classes at scale, held against the plain composition on
    the card bit for bit (exact-grid data), with CUDA-event times: a
    4-shard ShardedFlatIndex (K7 per shard) at 4 x 262,144 rows of D 384
    (bf16, int8) and 4 x 131,072 of D 768 (bf16), Bq 8 and 128, k 24,
    beside one FlatIndex over the same rows through K7 and through K4 (K5
    for int8); then a 4-shard ShardedIVFIndex over 4 x 262,144 clustered
    rows, nlist 1,024, nprobe 64: recall@24 against the exact top 24 and ms
    a search. The 10M-chunk configuration is cut to 1,048,576 rows."""
    import numpy as np

    from financial_rag_tpu_torch.index.flat import FlatIndex
    from financial_rag_tpu_torch.ops import ivf_probe, topk
    from financial_rag_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, search_devices

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 14)
    rows_out = []
    for dtype_name, d, rows in SHARD_SCALE:
        dtype = getattr(torch, dtype_name)
        idx = ShardedFlatIndex(search_devices(SHARDS, "cuda"), dim=d, capacity_per_shard=rows,
                               dtype=dtype)
        check(idx.backend == "pallas_bucketed" and idx.cap_per_shard == rows,
              f"sharded scale: {idx.backend} {idx.cap_per_shard}")
        fill_sharded(torch, idx, rows, gen)
        # one FlatIndex over the same rows, in global slot order
        flats = {}
        for name, backend in (("bucketed_topk", "pallas_bucketed"),
                              ("packed_topk_fused" if dtype != torch.int8
                               else "bucketed_topk_fused", "pallas_fused")):
            f = FlatIndex(dim=d, capacity=rows * SHARDS, dtype=dtype, backend=backend,
                          device="cuda")
            f._vectors.copy_(torch.cat([s._vectors for s in idx.shards]))
            f._valid.copy_(torch.cat([s._valid for s in idx.shards]))
            f._ids[:] = np.concatenate([s._ids for s in idx.shards])
            f._slot_of = dict(zip(f._ids.tolist(), range(rows * SHARDS)))
            f._next_slot = rows * SHARDS
            flats[name] = f
        for bq in SHARD_SCALE_BQ:
            q = (torch.randint(-3, 4, (bq, d), generator=gen, device="cuda").float() / 64)
            q = q.cpu().numpy()
            before = topk.LAUNCHES["bucketed_topk"]
            got_ids, got_s = idx.search(q, SHARD_K)
            check(topk.LAUNCHES["bucketed_topk"] == before + SHARDS,
                  f"sharded scale: K7 not once a shard ({before})")
            want_ids, want_s = plain_sharded(torch, idx, q, SHARD_K)
            exact = bool((got_ids == want_ids).all() and (got_s == want_s).all())
            check(exact, f"sharded scale {dtype_name} D={d} Bq={bq}: K7 per shard differs "
                         "from the plain composition")
            row = {"phase": "sharded_scale", "dtype": dtype_name, "d": d, "shards": SHARDS,
                   "rows": rows * SHARDS, "bq": bq, "k": SHARD_K, "bit_equal_to_plain": exact,
                   "sharded_ms": cuda_ms(torch, lambda: idx.search(q, SHARD_K)),
                   "plain_ms": cuda_ms(torch, lambda: plain_sharded(torch, idx, q, SHARD_K))}
            for name, f in flats.items():
                row[f"flat_{name}_ms"] = cuda_ms(torch, lambda: f.search(q, SHARD_K))
            emit(row)
            rows_out.append(row)
        del idx, flats
        torch.cuda.empty_cache()

    # the sharded IVF over clustered rows (random-weight-free: real
    # embeddings cluster), exact top 24 by one matmul on the card
    plan = SHARD_IVF
    d = 384
    centers = torch.nn.functional.normalize(
        torch.randn(plan["centers"], d, generator=gen, device="cuda"), dim=1)
    ivf = ShardedIVFIndex(search_devices(SHARDS, "cuda"), dim=d, nlist=plan["nlist"],
                          list_size=plan["list_size"], nprobe=plan["nprobe"])
    n = plan["rows"] * SHARDS
    xs = []
    for lo in range(0, n, 65536):
        c = centers[torch.randint(0, plan["centers"], (65536,), generator=gen, device="cuda")]
        xs.append(torch.nn.functional.normalize(
            c + 0.6 * torch.randn(65536, d, generator=gen, device="cuda") / d ** 0.5, dim=1))
    x = torch.cat(xs)
    t0 = time.perf_counter()
    ivf.train(x[torch.randperm(n, generator=gen, device="cuda")[:65536]].cpu().numpy(),
              iters=8, seed=seed)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, n, 65536):
        ivf.upsert(np.arange(lo + 1, lo + 65537), x[lo:lo + 65536].cpu().numpy())
    upsert_s = time.perf_counter() - t0
    check(ivf.count() == n and all(len(s) == plan["rows"] for s in ivf.shards),
          f"sharded ivf scale: {[len(s) for s in ivf.shards]}")
    qi = torch.randint(0, n, (128,), generator=gen, device="cuda")
    qv = torch.nn.functional.normalize(x[qi] + 0.3 * torch.randn(128, d, generator=gen,
                                                                  device="cuda") / d ** 0.5,
                                       dim=1)
    exact = torch.sort(qv @ x.T, dim=1, descending=True, stable=True).indices[:, :SHARD_K]
    exact = (exact + 1).cpu().numpy()
    ivf_rows = {}
    for bq in SHARD_SCALE_BQ:
        q = qv[:bq].cpu().numpy()
        before = ivf_probe.LAUNCHES
        got_ids, _ = ivf.search(q, SHARD_K)
        launches = ivf_probe.LAUNCHES - before
        check(launches >= SHARDS, f"sharded ivf scale: K8 launched {launches} times")
        recall = float(np.mean([len(set(a) & set(b)) / SHARD_K
                                for a, b in zip(got_ids.tolist(), exact[:bq].tolist())]))
        ivf_rows[bq] = {"recall_at_24": recall, "probe_launches": launches,
                        "ms": cuda_ms(torch, lambda: ivf.search(q, SHARD_K))}
    emit({"phase": "sharded_ivf_scale", "shards": SHARDS, "rows": n, "d": d,
          "nlist": plan["nlist"], "nprobe": plan["nprobe"],
          "list_size": ivf.shards[0].list_size, "train_s": round(train_s, 3),
          "upsert_s": round(upsert_s, 3), "by_bq": ivf_rows,
          "cut": "10M-chunk configuration (BASELINE configs[4]) cut to 1,048,576 rows"})
    del ivf, x
    torch.cuda.empty_cache()
    return rows_out


WIDE_LAYERS = 12      # bge-base-en-v1.5 and gte-base at full depth
WIDE_COS_MIN = 0.999  # card (bf16) against the CPU (f32) embeddings, as phase 10


def write_wide_checkpoints(root: Path, seed: int, layers: int = WIDE_LAYERS,
                           names=("bge-base", "gte-base"), labels: int = 0):
    """Seeded random-weight checkpoints at the bge-base-en-v1.5 and gte-base
    shapes (WordPiece BERT: hidden 768, 12 heads of 64, FFN 3,072, vocab
    30,522, 512 positions), config.json + model.npz; the vendored vocab.
    ``labels`` > 0: cross-encoders with that many labels."""
    from financial_rag_tpu_torch.config import ModelConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params, save_params_npz

    raw = {"hidden_size": 768, "num_attention_heads": 12, "intermediate_size": 3072,
           "vocab_size": 30522, "max_position_embeddings": 512, "type_vocab_size": 2,
           "layer_norm_eps": 1e-12, "num_hidden_layers": layers, "architectures": ["BertModel"]}
    if labels:
        raw.update(architectures=["BertForSequenceClassification"],
                   id2label={str(i): f"LABEL_{i}" for i in range(labels)})
    paths = {}
    for i, name in enumerate(names):
        d = root / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(raw))
        cfg = ModelConfig.from_json(d)
        check(cfg.hidden_size == 768 and cfg.num_heads == 12 and cfg.num_labels == labels,
              f"config of {name}")
        save_params_npz(random_params(cfg, seed=seed + 10 + i), d / "model.npz")
        paths[name] = d
    return paths


def wide_parity(rt, paths: dict, texts) -> dict:
    """16 distinct corpus texts through the wide runtime's encoders on the
    card (bf16) and through the same weights on the CPU (f32, plain
    versions): the smallest cosine of each encoder."""
    import numpy as np

    from financial_rag_tpu_torch.models.encoder import Encoder

    sample = list(dict.fromkeys(texts))[:16]
    check(len(sample) == 16, "wide: fewer than 16 distinct corpus texts")
    out = {}
    for name, path, pooling in (("baai", paths["bge-base"], "cls"),
                                ("gte", paths["gte-base"], "mean")):
        gpu = rt.dual_encoder.encoders[name].encode(sample)
        cpu = Encoder.from_pretrained(str(path), pooling=pooling, device="cpu").encode(sample)
        check(gpu.shape == cpu.shape == (16, 768), f"wide {name}: embeddings {gpu.shape}")
        cos = (gpu * cpu).sum(1) / (np.linalg.norm(gpu, axis=1) * np.linalg.norm(cpu, axis=1))
        out[f"{name}_min_cos"] = float(cos.min())
        check(cos.min() >= WIDE_COS_MIN, f"wide {name} embeddings: min cosine {cos.min()}")
    return out


def phase_wide(torch, cfg, work: Path, items, seed: int):
    """The bge-base width: the flat bf16 runtime with 768-wide baai (CLS)
    and gte (mean) encoders at full depth beside the 384-wide MiniLM
    reranker, so one process serves both widths through the same kernels.
    Build on the card, ingest phase 4's corpus, the 9 golden questions;
    K1-K3 launched while only the wide encoders run (ingest) and K1-K4 on
    the queries (the index is 768-wide); 16 children's embeddings against
    the f32 CPU path; a profile as in phase 5; then the indexes reloaded
    as int8 on a copy of the data dir (no feedback.db) and the 9 questions
    through K5 at D=768.
    The p50s and the ingest rate are printed, not gated, and are no gain
    or loss against the D=384 phases."""
    from financial_rag_tpu_torch.models.encoder import Encoder
    from financial_rag_tpu_torch.runtime import Runtime

    t0 = time.perf_counter()
    paths = write_wide_checkpoints(work / "models_wide", seed)
    checkpoints_s = time.perf_counter() - t0
    cfg = copy.deepcopy(cfg)
    cfg.encoders.baai_path = str(paths["bge-base"])
    cfg.encoders.gte_path = str(paths["gte-base"])
    reset_launches()
    t_build = time.perf_counter()
    rt = Runtime.build(cfg, data_dir=work / "data_wide", device="cuda")
    build_s = time.perf_counter() - t_build
    encoders = {n: getattr(e, "inner", None) for n, e in rt.dual_encoder.encoders.items()}
    check(all(isinstance(e, Encoder) and e.dim == 768 for e in encoders.values()),
          f"wide: the encoders are not the 768-wide checkpoints ({encoders})")
    check(all(i.dim == 768 and i.backend == "pallas_fused" and i.dtype == torch.bfloat16
              for i in rt.indexes.values()), "wide: an index is not 768-wide bf16 on K4")
    check(rt.engine.reranker.model is not None, "wide: the cross-encoder did not load")

    children, ingest_s = ingest_all(rt, items)
    ingest_launches = read_launches()
    check_path_launched(("masked_mean_l2_normalize", "flash_attention", "fused_ffn"),
                        ingest_launches, "wide ingest (the 768-wide encoders alone)")
    query_ms, answers, methods = golden_queries(rt, "wide flat bf16")
    launches = read_launches()
    query_launches = {name: launches[name] - ingest_launches[name] for name in launches}
    check_path_launched(FLAT_PATH, query_launches, "wide flat bf16 query path")
    parity = wide_parity(rt, paths, [c["text"] for out in answers
                                     for c in out["top_children_chunks"]])
    phase_profile(torch, rt, label="wide flat bf16")

    rt.save_indexes(work / "data_wide")
    shutil.copytree(work / "data_wide", work / "data_wide_int8",
                    ignore=shutil.ignore_patterns("feedback.db*"))
    cfg8 = copy.deepcopy(cfg)
    cfg8.index.dtype = "int8"
    reset_launches()
    rt8 = Runtime.build(cfg8, data_dir=work / "data_wide_int8", device="cuda")
    check(all(i.dtype == torch.int8 and i.dim == 768 and i.backend == "pallas_fused"
              and i.count() == children for i in rt8.indexes.values()),
          "wide: the int8 runtime did not reload the 768-wide indexes")
    int8_ms, _, int8_methods = golden_queries(rt8, "wide int8")
    int8_launches = read_launches()
    check_path_launched(INT8_PATH, int8_launches, "wide int8 path")
    emit({"phase": "wide", "layers": WIDE_LAYERS, "children": children,
          "index_dim": {n: i.dim for n, i in rt.indexes.items()},
          "checkpoints_s": round(checkpoints_s, 3), "runtime_build_s": round(build_s, 3),
          "ingest_s": round(ingest_s, 3), "children_per_s": round(children / ingest_s, 1),
          "query_p50_ms": round(statistics.median(query_ms), 3),
          "query_max_ms": round(max(query_ms), 3), "reranked_methods": methods,
          "int8_query_p50_ms": round(statistics.median(int8_ms), 3),
          "int8_query_max_ms": round(max(int8_ms), 3), "int8_reranked_methods": int8_methods,
          **parity, "launches_ingest": ingest_launches, "launches_queries": query_launches,
          "launches_int8": int8_launches})
    del rt, rt8
    torch.cuda.empty_cache()


def _http(url: str, body=None, timeout: float = 300.0):
    """(status, body bytes, ms) of one GET, or POST of ``body`` as JSON."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, raw, (time.perf_counter() - t0) * 1e3


SERVE_CLIENTS = 3   # client threads, 3 golden questions each


def phase_serve(torch, cfg, work: Path, served: dict, info: dict):
    """The HTTP surface on the card: Runtime.build on a copy of the flat
    data dir (without feedback.db, whose result cache would answer the
    questions), make_processor, make_app and make_server on 127.0.0.1 port
    0, served from a thread. /health reports both collections; the 9 golden
    questions go to /search from SERVE_CLIENTS threads at once (then,
    reworded, one at a time), each with
    phase 4's top-5 child ids and, all 9 together, phase 4's launch count of
    each flat-path kernel (none lost to the worker threads); 3 to
    /search-stream, each with the events chunks, answer, complete; a bad
    query is 400, an unknown path 404; the flat path's kernels launched
    over HTTP. The server and the app's
    threads are stopped before the phase returns."""
    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.serving.app import make_server

    data = work / "data_serve"
    shutil.copytree(work / "data", data, ignore=shutil.ignore_patterns("feedback.db*"))
    rt = Runtime.build(cfg, data_dir=data, device="cuda")
    app = rt.make_app(processor=rt.make_processor(data), data_dir=data)
    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, name="chip-smoke-http", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        status, raw, _ = _http(f"{base}/health")
        health = json.loads(raw)
        want = {name: served["children"] for name in rt.indexes}
        check(status == 200 and health.get("indexes") == want,
              f"serve: /health {status} {health}, expected indexes {want}")

        reset_launches()
        results, errors = {}, []

        def client(questions):
            try:
                for q in questions:
                    results[q] = _http(f"{base}/search", {"query": q})
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(repr(e))

        clients = [threading.Thread(target=client, args=(GOLDEN_QUESTIONS[i::SERVE_CLIENTS],))
                   for i in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        search_s = time.perf_counter() - t0
        check(not errors and not any(c.is_alive() for c in clients) and
              len(results) == len(GOLDEN_QUESTIONS), f"serve: /search clients failed: {errors}")
        mismatched = []
        for q, answer in zip(GOLDEN_QUESTIONS, served["answers"]):
            status, raw, _ = results[q]
            body = json.loads(raw)
            check(status == 200 and body.get("status") == "success",
                  f"serve: /search {q!r} gave {status} {body.get('status')}")
            got = {d["id"] for d in body["documents"][:5]}
            wanted = {str(c["child_id"]) for c in answer["top_children_chunks"][:5]}
            if got != wanted:
                mismatched.append((q, sorted(got), sorted(wanted)))
        check(not mismatched, f"serve: top-5 documents differ from RAGEngine.query's: "
                              f"{mismatched}")
        # the same questions did the same work as in phase 4, three at a
        # time on the app's worker threads: no launch count may be lost
        search_launches = read_launches()
        lost = {k: (search_launches[k], served["query_launches"][k]) for k in SERVE_PATH
                if search_launches[k] != served["query_launches"][k]}
        check(not lost, f"serve: /search launch counts differ from phase 4's (got, want): {lost}")
        # one request at a time, reworded past the result cache (as the
        # profile phases are): the HTTP layer's own cost beside the engine's
        sequential_ms = []
        for q in GOLDEN_QUESTIONS:
            status, raw, ms = _http(f"{base}/search", {"query": f"Tell me briefly: {q}"})
            check(status == 200 and json.loads(raw).get("status") == "success",
                  f"serve: sequential /search {q!r} gave {status}")
            sequential_ms.append(ms)

        streams = {}
        for q in GOLDEN_QUESTIONS[:3]:
            status, raw, ms = _http(f"{base}/search-stream", {"query": q})
            events = [json.loads(line[6:]) for line in raw.decode().splitlines()
                      if line.startswith("data: ")]
            types = [e["type"] for e in events]
            check(status == 200 and types == ["chunks", "answer", "complete"],
                  f"serve: /search-stream {q!r} gave {status} {types}")
            check(bool(events[0]["data"]["documents"]), f"serve: no chunks streamed for {q!r}")
            streams[q] = round(ms, 3)
        launches = read_launches()
        check_path_launched(SERVE_PATH, launches, "serve path")

        bad_status, _, _ = _http(f"{base}/search", {"query": ""})
        check(bad_status == 400, f"serve: an empty query gave {bad_status}, not 400")
        missing_status, raw, _ = _http(f"{base}/no-such-route")
        check(missing_status == 404 and json.loads(raw) == {"error": "not found"},
              f"serve: an unknown path gave {missing_status} {raw[:80]!r}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        app.close()
        rt.engine.flush_background()
    check(not thread.is_alive(), "serve: the server thread did not stop")
    http_ms = [results[q][2] for q in GOLDEN_QUESTIONS]
    emit({"phase": "serve", "card": info["nvidia_smi"], "port": server.server_port,
          "clients": SERVE_CLIENTS, "questions": len(http_ms),
          "http_p50_ms": round(statistics.median(http_ms), 3),
          "http_max_ms": round(max(http_ms), 3),
          "http_sequential_p50_ms": round(statistics.median(sequential_ms), 3),
          "http_sequential_max_ms": round(max(sequential_ms), 3),
          "engine_p50_ms": round(served["query_p50_ms"], 3),
          "search_wall_s": round(search_s, 3), "stream_ms": streams,
          "top5_match": len(GOLDEN_QUESTIONS), "launches_search": search_launches,
          "launches": launches})
    return launches


LOAD_THREADS = 64          # in-process clients of the load phase
LOAD_QUESTIONS = 192       # unique questions, 3 a client
LOAD_TIE_TOL = 1e-3        # top-5 near ties: fused final scores this close (reported)
LOAD_COS_MIN = 0.9999      # query embeddings, batched against unbatched
LOAD_MIN_SHARED = 0.8      # share of the rerank's candidates both runs hand it
LOAD_CE_TOL = 1e-2         # raw cross-encoder logits of the same pair, batched vs unbatched
HTTP_LOAD_CLIENTS = 16     # /search clients at MICROBATCH_DIRECT = HTTP_LOAD_DIRECT
HTTP_LOAD_DIRECT = 2       # below the app's 8 executor workers
HTTP_LOAD_QUESTIONS = 48
STREAM_LOAD = 4            # concurrent query_stream calls on the local LLM
STREAM_NEW_TOKENS = 32
STREAM_DIRECT = 1


def load_questions(n: int, tag: str):
    """n distinct questions (the golden ones, each with two filler words and
    a number): new to the result and embedding caches of every runtime."""
    w = FILLER_WORDS
    return [f"{GOLDEN_QUESTIONS[i % len(GOLDEN_QUESTIONS)]} {tag} {w[i % len(w)]} "
            f"{w[(7 * i + 3) % len(w)]} {i}" for i in range(n)]


def drive(fn, items, threads: int):
    """fn over items from `threads` threads, each taking the next item;
    returns ({item: (result, ms)}, wall seconds)."""
    lock, it = threading.Lock(), iter(items)
    out, errors = {}, []

    def worker():
        while True:
            with lock:
                item = next(it, None)
            if item is None:
                return
            try:
                t0 = time.perf_counter()
                res = fn(item)
                out[item] = (res, (time.perf_counter() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001 -- reported by the caller
                errors.append(f"{item!r}: {e!r}")

    ts = [threading.Thread(target=worker, name=f"load-{i}") for i in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in ts) and len(out) == len(items),
          f"load: clients failed: {errors[:3]}")
    return out, wall


def latency(results: dict, wall: float) -> dict:
    ms = sorted(v[1] for v in results.values())
    return {"requests": len(ms), "wall_s": wall, "qps": len(ms) / wall,
            "p50_ms": statistics.median(ms), "p95_ms": ms[int(0.95 * (len(ms) - 1))],
            "max_ms": ms[-1]}


def batcher_stats(rt) -> dict:
    """Every batcher's counts: the sweep waves (MultiIndexBatcher, per k:
    the vector waves and the chained encode+sweep waves), the encoders'
    (BatchingEncoder has no stats(); its MicroBatcher's counts), the
    rerank's and the LLM's."""
    out = {"sweep": rt.hybrid.sweep_batcher.stats()}
    for name, enc in rt.dual_encoder.encoders.items():
        mb = enc.batcher
        out[f"encode-{name}"] = {"calls": mb.calls, "submitted": mb.submitted,
                                 "direct": mb.direct_calls}
    out["rerank"] = rt.engine.reranker.model.stats()
    if hasattr(rt.engine.llm, "stats"):
        out["llm"] = rt.engine.llm.stats()
    return out


def top5(out: dict):
    """(ids, the scores the engine ranked them by) of the top 5 children."""
    chunks = out["top_children_chunks"][:5]
    return ([c["child_id"] for c in chunks],
            [float(c["final_rerank_score"] if c.get("final_rerank_score") is not None
                   else c["retrieval_score"]) for c in chunks])


def record_reranks(rt) -> dict:
    """{question: (candidates [(child id, hybrid fused score)] as the rerank
    got them, {child id: raw cross-encoder logit})}, from every rerank of
    the runtime's engine from now on."""
    seen, lock = {}, threading.Lock()
    rerank = rt.engine.reranker.rerank_chunks

    def recording(query, chunks, **kw):
        before = [(c["child_id"], float(c.get("retrieval_score", 0.0))) for c in chunks]
        out = rerank(query, chunks, **kw)
        raw = {c["child_id"]: c.get("cross_encoder_score_raw") for c in out}
        with lock:
            seen[query] = (before, raw)
        return out

    rt.engine.reranker.rerank_chunks = recording
    return seen


def compare_load(got: dict, want: dict):
    """Batched against unbatched, question by question, on the numbers the
    batchers compute. Gates: each query embedding (both models) within
    cosine LOAD_COS_MIN of the unbatched one; the rerank's candidates
    sharing at least LOAD_MIN_SHARED of their ids; each shared candidate's
    raw cross-encoder logit within LOAD_CE_TOL. A request handed another
    request's rows fails all three: the random-weight embeddings of two
    different questions sit at cosine 0.993-0.9995 and share at most 14 of
    24 candidates on an H100 (PERF.md). Reported, not gated: the
    top-5 ids, identical or differing only between near ties (fused final
    scores within LOAD_TIE_TOL). The random-weight reranker's logits span
    0.006-0.008 within a question, so the rank-based normalization turns
    the bf16 differences of the batch shapes (K3's split and cuBLAS's
    algorithm follow the row count) into reorders of the top 5. Returns
    (counts, the failures)."""
    import numpy as np

    counts = {"questions": len(got), "top5_identical": 0, "top5_near_tie": 0,
              "top5_overlap_hist": [0] * 6, "candidates_identical": 0,
              "min_shared_candidates": None, "min_embedding_cos": 1.0,
              "max_ce_logit_diff": 0.0}
    bad = []
    for q, g in got.items():
        w = want[q]
        for gv, wv in zip(g["vecs"], w["vecs"]):
            cos = float(gv @ wv / (np.linalg.norm(gv) * np.linalg.norm(wv)))
            counts["min_embedding_cos"] = min(counts["min_embedding_cos"], cos)
            if cos < LOAD_COS_MIN:
                bad.append((q, "embedding cosine", cos))
        (gc, graw), (wc, wraw) = g["rerank"], w["rerank"]
        gids, wids = [c for c, _ in gc], [c for c, _ in wc]
        counts["candidates_identical"] += gids == wids
        shared = len(set(gids) & set(wids))
        if counts["min_shared_candidates"] is None or shared < counts["min_shared_candidates"][0]:
            counts["min_shared_candidates"] = (shared, len(wids))
        if shared < LOAD_MIN_SHARED * len(wids):
            bad.append((q, "candidates", shared, len(wids)))
        for cid in set(graw) & set(wraw):
            if graw[cid] is not None and wraw[cid] is not None:
                d = abs(graw[cid] - wraw[cid])
                counts["max_ce_logit_diff"] = max(counts["max_ce_logit_diff"], d)
                if d > LOAD_CE_TOL:
                    bad.append((q, "cross-encoder logit", cid, graw[cid], wraw[cid]))
        gt, wt = g["top5"], w["top5"]
        counts["top5_overlap_hist"][len(set(gt) & set(wt))] += 1
        if gt == wt:
            counts["top5_identical"] += 1
        elif len(gt) == len(wt) and all(
                a == b or abs(sa - sb) <= LOAD_TIE_TOL
                for a, b, sa, sb in zip(gt, wt, g["top5_scores"], w["top5_scores"])):
            counts["top5_near_tie"] += 1
    return counts, bad


def phase_load(torch, cfg, work: Path, info: dict, seed: int):
    """The default serving runtime under load (SERVE_MICROBATCH=1,
    MICROBATCH_DIRECT=32, MAX=192, INFLIGHT=4), on copies of the flat data
    dir without feedback.db.
    (a) LOAD_THREADS threads call RAGEngine.query over LOAD_QUESTIONS
        unique questions, on the batched runtime and then on a
        SERVE_MICROBATCH=0 one: QPS, p50 and p95 of each, every batcher's
        counts; the sweep waves and the rerank coalesce (calls <
        submitted), K1-K4 launch, K4 fewer times than there are questions
        and K1 (one a gte forward) fewer times than unbatched. Each
        question against its unbatched answer (compare_load): the query
        embeddings, the rerank's candidates and its raw logits, each
        within its stated tolerance; the top-5 ids reported.
    (b) make_server at MICROBATCH_DIRECT=HTTP_LOAD_DIRECT, HTTP_LOAD_CLIENTS
        client threads on /search: the app's 8 executor workers exceed the
        direct limit, so the requests reach the sweep batcher.
    (c) LLM_PROVIDER=local in f32 at MICROBATCH_DIRECT=STREAM_DIRECT:
        STREAM_LOAD concurrent query_stream calls of STREAM_NEW_TOKENS new
        tokens join the continuous decode engine (engine_streams > 0), whose
        row prefills launch K9 from its worker thread; each engine stream's
        text equals the same prompt's per-request stream."""
    from financial_rag_tpu_torch.index import pending
    from financial_rag_tpu_torch.llm.local_llm import LocalLLM
    from financial_rag_tpu_torch.models import decoder
    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.serving.app import make_server
    from financial_rag_tpu_torch.serving.batcher import BatchingLLM

    def runtime(tag: str, c):
        data = work / f"data_load_{tag}"
        shutil.copytree(work / "data", data, ignore=shutil.ignore_patterns("feedback.db*"))
        return Runtime.build(c, data_dir=data, device="cuda"), data

    check(cfg.serving.microbatch and cfg.serving.microbatch_direct == 32
          and cfg.serving.microbatch_max == 192 and cfg.serving.microbatch_inflight == 4,
          f"load: not the default serving config ({cfg.serving})")
    questions = load_questions(LOAD_QUESTIONS, "load")
    modes, answers = {}, {}
    for mode, microbatch in (("batched", True), ("unbatched", False)):
        c = copy.deepcopy(cfg)
        c.serving.microbatch = microbatch
        rt, _ = runtime(mode, c)
        check((rt.hybrid.sweep_batcher is not None) == microbatch, f"load {mode}: wiring")
        rt.warm_sweeps()
        rt.engine.query("what is the total amount due")   # first launches, off the clock
        reranks = record_reranks(rt)
        copies = {}         # index/pending.device_get calls (one copy each) by thread
        device_get = pending.device_get

        def counting_device_get(tree):
            name = re.sub(r"[-_]\d+$", "", threading.current_thread().name)
            copies[name] = copies.get(name, 0) + 1
            return device_get(tree)

        pending.device_get = counting_device_get
        reset_launches()
        try:
            results, wall = drive(rt.engine.query, questions, LOAD_THREADS)
        finally:
            pending.device_get = device_get
        launches = read_launches()
        check(all(r.get("success") and r["top_children_chunks"] and not r.get("cache_hit")
                  for r, _ in results.values()), f"load {mode}: a query failed or was cached")
        cache = rt.dual_encoder.cache
        answers[mode] = {q: dict(zip(("top5", "top5_scores"), top5(r)), rerank=reranks[q],
                                 vecs=[cache.get(n, q) for n in rt.dual_encoder.names])
                         for q, (r, _) in results.items()}
        check(all(v is not None for a in answers[mode].values() for v in a["vecs"]),
              f"load {mode}: a query embedding is missing from the cache")
        modes[mode] = {**latency(results, wall), "launches": launches,
                       "pending_device_get_calls": copies}
        if microbatch:
            stats = batcher_stats(rt)
            modes[mode]["batchers"] = stats
            waves = sum(v["calls"] for k, v in stats["sweep"].items() if k.startswith("chained@"))
            wave_copies = sum(n for k, n in copies.items() if "-chained@" in k)
            modes[mode]["device_gets_per_chained_wave"] = wave_copies / max(waves, 1)
            check_path_launched(FLAT_PATH, launches, "load batched path")
            waves = {k: v for k, v in stats["sweep"].items() if v["submitted"]}
            check(waves and all(v["calls"] < v["submitted"] for v in waves.values()),
                  f"load: the sweep waves did not coalesce: {stats['sweep']}")
            check(stats["rerank"]["calls"] < stats["rerank"]["submitted"],
                  f"load: the rerank did not coalesce: {stats['rerank']}")
            check(launches["packed_topk_fused"] < LOAD_QUESTIONS,
                  f"load: K4 launched {launches['packed_topk_fused']} times for "
                  f"{LOAD_QUESTIONS} questions")
        del rt
        torch.cuda.empty_cache()
    check(modes["batched"]["launches"]["masked_mean_l2_normalize"]
          < modes["unbatched"]["launches"]["masked_mean_l2_normalize"],
          "load: the batched encodes did not coalesce (K1 launches)")
    agreement, bad = compare_load(answers["batched"], answers["unbatched"])
    if bad:
        (Path(tempfile.gettempdir()) / "chip_smoke_load_mismatches.json").write_text(
            json.dumps(bad, default=str))
    kinds = {}
    for b in bad:
        kinds[b[1]] = kinds.get(b[1], 0) + 1
    check(not bad, f"load: batched answers differ from the unbatched ones {kinds} "
                   f"({agreement}): {bad[:3]}")

    # (b) HTTP below the executor's worker count
    c = copy.deepcopy(cfg)
    c.serving.microbatch_direct = HTTP_LOAD_DIRECT
    rt, data = runtime("http", c)
    app = rt.make_app(data_dir=data)
    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, name="chip-smoke-load-http",
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        reset_launches()
        http_q = load_questions(HTTP_LOAD_QUESTIONS, "http")
        http, http_wall = drive(lambda q: _http(f"{base}/search", {"query": q}), http_q,
                                HTTP_LOAD_CLIENTS)
        for q, ((status, raw, _), _) in http.items():
            body = json.loads(raw)
            check(status == 200 and body.get("status") == "success" and body["documents"],
                  f"load http: /search {q!r} gave {status} {body.get('status')}")
        http_launches = read_launches()
        http_stats = batcher_stats(rt)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        app.close()
        rt.engine.flush_background()
    check(not thread.is_alive(), "load http: the server thread did not stop")
    check_path_launched(FLAT_PATH, http_launches, "load http path")
    queued = sum(v["submitted"] for v in http_stats["sweep"].values())
    check(queued > 0, f"load http: no request reached the sweep batcher: {http_stats}")
    http_line = {**latency({q: (None, ms) for q, ((_, _, ms), _) in http.items()}, http_wall),
                 "clients": HTTP_LOAD_CLIENTS, "microbatch_direct": HTTP_LOAD_DIRECT,
                 "batchers": http_stats, "launches": http_launches}
    del rt
    torch.cuda.empty_cache()

    # (c) concurrent answer streams through the continuous decode engine
    t0 = time.perf_counter()
    ckpt = work / "qwen2-0.5b"
    write_llm_checkpoint(ckpt, QWEN2_05B, seed + 10)
    checkpoint_s = time.perf_counter() - t0
    c = copy.deepcopy(cfg)
    c.llm.provider, c.llm.local_checkpoint = "local", str(ckpt)
    c.llm.local_dtype, c.llm.local_max_new_tokens = "float32", STREAM_NEW_TOKENS
    c.serving.microbatch_direct = STREAM_DIRECT
    rt, _ = runtime("llm", c)
    llm = rt.engine.llm
    check(isinstance(llm, BatchingLLM) and isinstance(llm.inner, LocalLLM),
          f"load llm: the provider is {type(llm).__name__}, not a BatchingLLM over LocalLLM")
    inner = llm.inner
    check(inner.available() and inner._params["embed"].dtype == torch.float32,
          "load llm: LocalLLM did not load in f32")
    runs = []
    via_engine = inner.stream_via_engine

    def recording_via(prompt, *, max_tokens=1024):
        gen = via_engine(prompt, max_tokens=max_tokens)
        if gen is None:
            return None
        rec = {"prompt": prompt, "max_tokens": max_tokens, "deltas": []}
        runs.append(rec)

        def tee():
            for d in gen:
                rec["deltas"].append(d)
                yield d
            rec["done"] = True
        return tee()

    k9_threads: dict = {}
    k9 = decoder.causal_flash_prefill

    def counting_k9(*a, **kw):
        name = threading.current_thread().name
        k9_threads[name] = k9_threads.get(name, 0) + 1
        return k9(*a, **kw)

    stream_q = [f"Please answer: {q}" for q in load_questions(STREAM_LOAD, "stream")]

    def stream(q):
        events = list(rt.engine.query_stream(q))
        kind, final = events[-1]
        check(kind == "complete" and final.get("success") is True, f"load llm: {q!r} failed")
        check(not final["answer"].startswith(DEGRADED), f"load llm: degraded {q!r}")
        return "".join(d for k, d in events if k == "answer_delta")

    inner.stream_via_engine, decoder.causal_flash_prefill = recording_via, counting_k9
    try:
        reset_launches()
        streams, stream_wall = drive(stream, stream_q, STREAM_LOAD)
        llm_launches = read_launches()
    finally:
        inner.stream_via_engine, decoder.causal_flash_prefill = via_engine, k9
    engine = inner._engine
    llm_stats = llm.stats()
    check(llm_stats["engine_streams"] > 0 and engine is not None,
          f"load llm: no stream joined the continuous engine ({llm_stats})")
    eng_stats = engine.stats()
    engine_k9 = k9_threads.get("continuous-decode", 0)
    layers = QWEN2_05B["num_hidden_layers"]
    check(eng_stats["joins"] > 0 and engine_k9 == layers * eng_stats["joins"],
          f"load llm: {engine_k9} K9 launches from the engine's prefills for "
          f"{eng_stats['joins']} joins ({k9_threads})")
    check_path_launched(LLM_PATH, llm_launches, "load llm path")
    mismatched = []
    for rec in runs:
        check(rec.get("done"), "load llm: an engine stream did not run to its end")
        want = "".join(inner.generate_stream(rec["prompt"], max_tokens=rec["max_tokens"]))
        if "".join(rec["deltas"]) != want:
            mismatched.append(("".join(rec["deltas"])[:80], want[:80]))
    check(not mismatched, f"load llm: engine streams differ from per-request streams: "
                          f"{mismatched}")
    engine.close()
    llm_line = {**latency({q: (None, ms) for q, (_, ms) in streams.items()}, stream_wall),
                "model": "Qwen2-0.5B shape, random weights, f32",
                "checkpoint_write_s": checkpoint_s, "new_tokens": STREAM_NEW_TOKENS,
                "microbatch_direct": STREAM_DIRECT, "engine_streams_checked": len(runs),
                "batching_llm": llm_stats, "engine": eng_stats,
                "k9_launches_by_thread": k9_threads, "launches": llm_launches}
    del rt, llm, inner, engine
    torch.cuda.empty_cache()

    emit({"phase": "load", "card": info["nvidia_smi"], "threads": LOAD_THREADS,
          "questions": LOAD_QUESTIONS, **{f"{m}": v for m, v in modes.items()},
          "qps_ratio": modes["batched"]["qps"] / modes["unbatched"]["qps"],
          "p50_ratio": modes["batched"]["p50_ms"] / modes["unbatched"]["p50_ms"],
          "batched_vs_unbatched": agreement,
          "http": http_line, "streams": llm_line})


def phase_backends(torch, rt, cfg, work: Path):
    """The saved flat (bf16) index through every backend: the golden
    questions' query vectors through K6 (pallas_exact), K7 (pallas_bucketed),
    K4 (pallas_fused) and K5 (pallas_fused over int8). Each kernel is held
    to its plain version on the same inputs (ids may differ only between
    scores within 1e-5; K5 on int8 exactly); recall@24 against K6 is
    reported, not gated: random-weight embeddings are anisotropic."""
    from financial_rag_tpu_torch.index.flat import FlatIndex
    from financial_rag_tpu_torch.ingest.pipeline import collection_slug
    from financial_rag_tpu_torch.ops import topk

    persist = work / "data" / cfg.index.persist_dir
    coll = collection_slug(getattr(cfg.encoders, "baai_name", "baai"))
    qv = rt.dual_encoder.encoders["baai"].encode(GOLDEN_QUESTIONS)
    variants = {"topk_matmul": dict(backend="pallas_exact"),
                "bucketed_topk": dict(backend="pallas_bucketed"),
                "packed_topk_fused": dict(backend="pallas_fused"),
                "bucketed_topk_fused": dict(backend="pallas_fused", dtype=torch.int8)}
    plains = {"topk_matmul": topk.topk_matmul_plain, "bucketed_topk": topk.bucketed_topk_plain,
              "packed_topk_fused": topk.packed_topk_fused_plain,
              "bucketed_topk_fused": topk.bucketed_topk_fused_plain}
    indexes = {name: FlatIndex.load(persist, name=coll, device="cuda", **kw)
               for name, kw in variants.items()}
    reset_launches()
    results = {name: idx.search(qv, 24)[0] for name, idx in indexes.items()}
    launches = read_launches()
    check_path_launched(tuple(variants), launches, "backends")
    exact = results["topk_matmul"]
    report = {}
    for name, idx in indexes.items():
        q = torch.from_numpy(qv).to(idx.device)
        ks, ki = getattr(topk, name)(q, idx._vectors, idx._valid, 24)
        ps, pi = plains[name](q, idx._vectors, idx._valid, 24)
        same = ki == pi
        worst = (ks - ps).abs()[~same].max().item() if (~same).any() else 0.0
        tol = 1e-5
        if name == "packed_topk_fused":   # K4 keeps scores to 2**(bits - 22)
            tol += 2.0 ** (max((idx.capacity // 1024 - 1).bit_length(), 1) - 22)
        exact_ok = name == "bucketed_topk_fused"
        ok = (torch.equal(ki, pi) and torch.equal(ks, ps)) if exact_ok else worst <= tol
        check(ok, f"backends: {name} differs from its plain version (worst pair {worst})")
        recall = float(sum(len(set(a) & set(b)) / 24 for a, b in
                           zip(results[name].tolist(), exact.tolist())) / len(exact))
        report[name] = {"backend": idx.backend, "dtype": str(idx.dtype).replace("torch.", ""),
                        "recall_at_24_vs_exact": recall,
                        "ids_identical_to_plain": same.float().mean().item(),
                        "worst_differing_pair": worst}
    emit({"phase": "backends", "index": coll, "vectors": indexes["topk_matmul"].count(),
          "capacity": indexes["topk_matmul"].capacity, "queries": len(qv),
          "launches": launches, "kernels": report})
    return launches


def _kernel_family(name: str) -> str:
    for family, needles in (("port kernels", ("attn_fwd_kernel", "attn_bwd_", "ffn_fwd_kernel",
                                              "packed_sweep_", "packed_merge_kernel",
                                              "pool_norm_kernel", "bucketed_sweep_kernel",
                                              "bucketed_extract_kernel", "bucketed_write_kernel",
                                              "bucketed_wgmma_sweep_kernel",
                                              "exact_sweep_kernel", "exact_merge_kernel",
                                              "exact_wgmma_sweep_kernel",
                                              "probe_kernel", "causal_fwd_")),
                            ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
                            ("copy", ("Memcpy", "Memset", "copy_"))):
        if any(n in name for n in needles):
            return family
    return "other"


def device_profile(prof, wall_ms: float, spans=()) -> dict:
    """Device busy time (the union of the kernels' and copies' own device
    intervals), idle share of ``wall_ms``, device time by family and by
    kernel, from one torch.profiler run. ``spans`` are the package's
    time_block labels, which also appear on the device timeline and would
    count their gaps as busy."""
    acts = [e for e in device_events(prof) if e.name not in spans]
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
    port = {}   # the port's kernels by bare name (no namespace, template or arguments)
    for n, (ms, c) in by_name.items():
        if _kernel_family(n) == "port kernels":
            bare = n.replace("(anonymous namespace)::", "").removeprefix("void ")
            port[bare.split("(")[0].split("<")[0]] = {"ms": ms, "calls": c}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ms_by_family": families,
            "top_device_ms": [{"name": n[:90], "ms": ms, "calls": c} for n, (ms, c) in top],
            "port_kernel_ms": port}


def phase_profile(torch, rt, label: str = "flat bf16", n_questions: int = len(GOLDEN_QUESTIONS)):
    """Where one query's time goes: the first ``n_questions`` golden
    questions, reworded so that neither the result cache nor the
    query-embedding cache answers them, run once more under torch.profiler.
    The host spans are the package's own time_block labels. A trace that
    must be made again (``profiled``) rewords the questions anew, so that
    the caches do not answer them."""
    from financial_rag_tpu_torch.utils.timing import GLOBAL_TIMER

    def run(attempt):
        lead = "Tell me briefly" + (f" ({attempt})" if attempt else "")
        questions = [f"{lead}: {q}" for q in GOLDEN_QUESTIONS[:n_questions]]
        GLOBAL_TIMER.reset()
        t0 = time.perf_counter()
        for q in questions:
            check(rt.engine.query(q).get("success") is True, f"profiled query failed: {q!r}")
        torch.cuda.synchronize()
        return questions, (time.perf_counter() - t0) * 1e3

    prof, (questions, wall_ms) = profiled(torch, run, with_cpu=True)
    spans = GLOBAL_TIMER.summary()
    summary = device_profile(prof, wall_ms, spans)
    emit({"phase": "profile", "runtime": label, "queries": len(questions), **summary,
          "host_span_ms": {k: v["total_s"] * 1e3 for k, v in list(spans.items())[:14]}})
    return summary["port_kernel_ms"]


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


class _StepRecorder:
    """Wraps the decoder's prefill (CUDA events around it, keyed by prompt
    shape) and its decode steps (host clock around each verify step, which
    ends in a device sync, and the tokens it emitted) for one phase."""

    def __init__(self, torch):
        from financial_rag_tpu_torch.models import decoder

        self.torch, self.decoder = torch, decoder
        self.prefills, self.steps = [], []
        self._prefill, self._step = decoder._prefill, decoder._Spec.step

    def __enter__(self):
        torch, rec = self.torch, self

        def prefill(params, input_ids, attention_mask, max_total, cfg):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = rec._prefill(params, input_ids, attention_mask, max_total, cfg)
            end.record()
            rec.prefills.append((tuple(input_ids.shape), start, end))
            return out

        def step(spec):
            t0 = time.perf_counter()
            emit, n = rec._step(spec)
            rec.steps.append(((time.perf_counter() - t0) * 1e3, n))
            return emit, n

        self.decoder._prefill, self.decoder._Spec.step = prefill, step
        return self

    def __exit__(self, *exc):
        self.decoder._prefill, self.decoder._Spec.step = self._prefill, self._step

    def summary(self) -> dict:
        self.torch.cuda.synchronize()
        by_shape: dict = {}
        for shape, start, end in self.prefills:
            by_shape.setdefault(shape, []).append(start.elapsed_time(end))
        step_ms = [ms for ms, _ in self.steps]
        return {"prefills": len(self.prefills),
                "prompt_buckets": sorted({shape[1] for shape in by_shape}),
                "prefill_ms_by_shape": {f"B={b},S={s}": statistics.median(v)
                                        for (b, s), v in sorted(by_shape.items())},
                "verify_steps": len(self.steps),
                "verify_step_ms_p50": statistics.median(step_ms) if step_ms else None,
                "tokens_per_verify_step": (sum(n for _, n in self.steps) / len(self.steps)
                                           if self.steps else None)}


def serve_local_llm(torch, cfg, work: Path, ckpt: Path, hf: dict, what: str, questions,
                    stream_questions):
    """Runtime.build(device="cuda") with LLM_PROVIDER=local on ``ckpt`` (bf16,
    LLM_MAX_NEW_TOKENS=LLM_SMOKE_NEW_TOKENS) over a copy of the flat data
    dir without the feedback DB, whose result cache would answer the
    questions; warm() (the 4,096 prompt bucket), ``questions`` through
    RAGEngine.query and ``stream_questions`` through query_stream, with
    every launch counter set to 0 before the build. Random weights never
    emit eos, so every generation runs to its new-token bucket. LocalLLM
    and the provider swallow exceptions by design, so the checks are that
    the model loaded in bf16 on the card, that no answer is the
    degradation text, that no stream fell back to one-shot synthesis, that
    every kernel of LLM_PATH launched, K9 once a layer and a prefill, and
    that a 4,096-token prefill ran. Returns (runtime, its LocalLLM, the
    query outputs, and the timings, prefill stats and launches)."""
    from financial_rag_tpu_torch.llm.local_llm import LocalLLM
    from financial_rag_tpu_torch.runtime import Runtime

    data = work / f"data_{what}"
    shutil.copytree(work / "data", data, ignore=shutil.ignore_patterns("feedback.db*"))
    cfg = copy.deepcopy(cfg)
    cfg.llm.provider, cfg.llm.local_checkpoint = "local", str(ckpt)
    cfg.llm.local_dtype = "bfloat16"
    cfg.llm.local_max_new_tokens = LLM_SMOKE_NEW_TOKENS

    reset_launches()
    with _StepRecorder(torch) as rec:
        t_build = time.perf_counter()
        rt = Runtime.build(cfg, data_dir=data, device="cuda")
        llm = getattr(rt.engine.llm, "inner", None)     # BatchingLLM by default
        check(isinstance(llm, LocalLLM) and llm.device.type == "cuda",
              f"{what}: the provider is {type(rt.engine.llm).__name__} over "
              f"{type(llm).__name__}, not a BatchingLLM over a LocalLLM on the card")
        t_warm = time.perf_counter()
        check(llm.warm() is True and not llm._failed, f"{what}: LocalLLM did not load (see the log)")
        warm_s = time.perf_counter() - t_warm
        build_s = t_warm - t_build
        check(llm._params["embed"].dtype == torch.bfloat16, f"{what}: the decoder is not in bf16")
        query_ms, answers = [], []
        for question in questions:
            tq = time.perf_counter()
            out = rt.engine.query(question)
            query_ms.append((time.perf_counter() - tq) * 1e3)
            check(out.get("success") is True and not out.get("cache_hit"),
                  f"{what}: query failed or cached: {question!r}")
            check(bool(out["answer"]) and not out["answer"].startswith(DEGRADED),
                  f"{what}: degraded answer for {question!r}: {out['answer'][:120]!r}")
            answers.append(out)
        stream_ms = []
        for question in stream_questions:
            tq = time.perf_counter()
            events = list(rt.engine.query_stream(f"Please answer: {question}"))
            stream_ms.append((time.perf_counter() - tq) * 1e3)
            kind, final = events[-1]
            deltas = "".join(d for k, d in events if k == "answer_delta")
            check(kind == "complete" and final.get("success") is True,
                  f"{what}: stream failed: {question!r}")
            check(bool(deltas.strip()) and deltas.strip() == final["answer"],
                  f"{what}: the stream of {question!r} fell back to one-shot synthesis")
            check(not final["answer"].startswith(DEGRADED), f"{what}: degraded stream {question!r}")
        served = rec.summary()
    launches = read_launches()
    check_path_launched(LLM_PATH, launches, f"{what} path")
    check(launches["causal_flash_prefill"] == hf["num_hidden_layers"] * served["prefills"],
          f"{what}: {launches['causal_flash_prefill']} K9 launches for {served['prefills']} prefills")
    check(4096 in served["prompt_buckets"], f"{what}: no 4,096-token prefill ({served})")
    stats = {"runtime_build_s": build_s, "warm_s": warm_s,
             "query_p50_ms": statistics.median(query_ms), "query_max_ms": max(query_ms),
             "queries": len(query_ms), "stream_ms": stream_ms, **served, "launches": launches}
    return rt, llm, cfg, answers, stats


def phase_llm(torch, cfg, work: Path, seed: int):
    """On-device answer synthesis: a seeded random-weight checkpoint at the
    Qwen2-0.5B shape (full width and depth, bf16, WordLevel tokenizer over
    the corpus words padded to the 151,936 ids) served by serve_local_llm:
    the 9 golden questions through RAGEngine.query (two generations each:
    the query normaliser and the answer, both through prompt-lookup
    speculation) and 3 through query_stream. Then generate against the
    joined stream, a generate_many wave and LLM_DTYPE=int8. With random
    weights the normaliser rewrites each question into random words: this
    phase tests the path, not the answers' quality."""
    from financial_rag_tpu_torch.llm.local_llm import LocalLLM
    from financial_rag_tpu_torch.llm.prompts import QUERY_NORMALIZE

    t0 = time.perf_counter()
    ckpt = work / "qwen2-0.5b"
    if not (ckpt / "config.json").exists():      # the load phase wrote it
        write_llm_checkpoint(ckpt, QWEN2_05B, seed + 10)
    checkpoint_s = time.perf_counter() - t0
    rt, llm, cfg, answers, stats = serve_local_llm(torch, cfg, work, ckpt, QWEN2_05B, "llm",
                                                   GOLDEN_QUESTIONS, GOLDEN_QUESTIONS[:3])

    # one answer prompt, one-shot against streamed; a generate_many wave of
    # three buckets; the int8 weight-only layout
    prompt = answers[0]["llm_prompt"]
    one_shot = llm.generate(prompt)
    streamed = "".join(llm.generate_stream(prompt)).strip()
    check(bool(one_shot) and one_shot == streamed,
          f"llm: generate and joined generate_stream differ: {one_shot!r} vs {streamed!r}")
    wave = [prompt, QUERY_NORMALIZE.format(question=GOLDEN_QUESTIONS[0]), "rent lease amount"]
    buckets = [llm._prep(p)[0].shape[1] for p in wave]
    t_many = time.perf_counter()
    many = llm.generate_many(wave)
    many_ms = (time.perf_counter() - t_many) * 1e3
    check(len(many) == 3 and all(isinstance(t, str) and t for t in many), f"generate_many {many}")
    t_int8 = time.perf_counter()
    llm8 = LocalLLM(cfg.llm, dtype="int8", device="cuda")
    text8 = llm8.generate(prompt)
    int8_s = time.perf_counter() - t_int8
    check(not llm8._failed and llm8._params["layers"][0]["qkv_w"]["q"].dtype == torch.int8,
          "llm: the int8 LocalLLM did not load")
    check(bool(text8) and not text8.startswith(DEGRADED), f"llm: int8 answer {text8!r}")
    emit({"phase": "llm", "model": "Qwen2-0.5B shape, random weights, bf16",
          "checkpoint_write_s": checkpoint_s, **stats,
          "max_new_tokens": cfg.llm.local_max_new_tokens, "spec_k": cfg.llm.local_spec_k,
          "generate_many_buckets": buckets, "generate_many_ms": many_ms,
          "int8_load_and_generate_s": int8_s, "answer_sample": answers[0]["answer"][:160]})
    del llm8
    torch.cuda.empty_cache()
    return rt, ckpt, stats["launches"]


def phase_llm_d128(torch, cfg, work: Path, seed: int):
    """A head-128 decoder served at full width: a seeded random-weight
    checkpoint at the Qwen2-1.5B shape (28 layers of 1,536, 12 query and 2
    kv heads of 128, FFN 8,960, vocab 151,936, q/k/v biases, tied
    embeddings; 1.54 B parameters, 3.1 GB in bf16) with the committed
    byte-level BPE fixture as its tokenizer (padded to the vocabulary),
    served by serve_local_llm: 3 golden questions through RAGEngine.query
    and 1 through query_stream, so K9's head-128 kernel runs in every
    prefill. Returns the launches."""
    t0 = time.perf_counter()
    ckpt = work / "qwen2-1.5b"
    write_llm_checkpoint(ckpt, QWEN2_15B, seed + 18, bpe_fixture=BPE_FIXTURE)
    checkpoint_s = time.perf_counter() - t0
    rt, llm, _, answers, stats = serve_local_llm(torch, cfg, work, ckpt, QWEN2_15B, "llm_d128",
                                                 GOLDEN_QUESTIONS[:3], GOLDEN_QUESTIONS[3:4])
    check(llm._dcfg.head_dim == 128, f"llm_d128: head_dim {llm._dcfg.head_dim}, not 128")
    emit({"phase": "llm_d128", "model": "Qwen2-1.5B shape, random weights, bf16, BPE fixture",
          "checkpoint_write_s": checkpoint_s, **stats,
          "k9_launches": stats["launches"]["causal_flash_prefill"],
          "seconds": time.perf_counter() - t0, "answer_sample": answers[0]["answer"][:160]})
    del rt, llm
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return stats["launches"]


CLI_SCRIPTS = ("ingest_all", "check_collections", "test_full_flow", "pc_retrieval_smoke",
               "pc_llm_answer", "recall_eval")
CLI_PATH = LLM_PATH     # K1-K4 on ingest and queries, K9 on every prefill
ENCODE_PROMPT_TOKENS = 4096   # LocalLLM's max_prompt_tokens


def check_probes(tok, fixture: Path) -> int:
    """The reader's ids and decoded text on the fixture's probe strings must
    be the ones tokenizers wrote into probes.json. Returns the probe count."""
    probes = json.loads((fixture / "probes.json").read_text(encoding="utf-8"))
    for p in probes:
        ids = tok.encode(p["text"]).ids
        check(ids == p["ids"], f"cli: reader ids of {p['text']!r}: {ids} != {p['ids']}")
        check(tok.decode(ids) == p["decoded"]
              and tok.decode(ids, skip_special_tokens=False) == p["decoded_with_special"],
              f"cli: reader decode of {p['text']!r}")
    return len(probes)


def encode_ms(tok_path: Path):
    """(tokens, first ms, steady ms) of one prompt of at least
    ENCODE_PROMPT_TOKENS tokens through a fresh reader (the first call fills
    its word caches; steady is the median of 5 more)."""
    from financial_rag_tpu_torch.tokenizer.hf_json import HFTokenizer

    tok = HFTokenizer.from_file(tok_path)
    docs = list(GOLDEN_CORPUS.values())
    text = ""
    while len(tok.encode(text).ids) < ENCODE_PROMPT_TOKENS:
        text += docs[len(text) % len(docs)]
    tok = HFTokenizer.from_file(tok_path)
    t0 = time.perf_counter()
    n = len(tok.encode(text).ids)
    first = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        tok.encode(text)
        times.append((time.perf_counter() - t0) * 1e3)
    return n, first, statistics.median(times)


def run_cli_script(name: str, argv) -> tuple:
    """financial_rag_tpu_torch.scripts.<name>.main(argv) in this process:
    (return code, stdout, seconds)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"financial_rag_tpu_torch.scripts.{name}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = mod.main([str(a) for a in argv])
    return rc, out.getvalue(), time.perf_counter() - t0


def phase_cli(torch, work: Path, seed: int):
    """The operator CLI on the card (module docstring, phase 18). Returns
    the phase's launches."""
    from financial_rag_tpu_torch.llm.local_llm import LocalLLM
    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.tokenizer.hf_json import HFTokenizer

    t_phase = time.perf_counter()
    ckpt = work / "qwen2-0.5b-bpe"
    # phase 11's weights (its seed), this tokenizer
    write_llm_checkpoint(ckpt, QWEN2_05B, seed + 10, bpe_fixture=BPE_FIXTURE)
    t_load = time.perf_counter()         # the process's first reader builds the \p{..} classes
    fixture_tok = HFTokenizer.from_file(BPE_FIXTURE / "tokenizer.json")
    reader_load_s = time.perf_counter() - t_load
    probes = check_probes(fixture_tok, BPE_FIXTURE)
    check_probes(HFTokenizer.from_file(ckpt / "tokenizer.json"), BPE_FIXTURE)
    prompt_tokens, encode_first_ms, encode_steady_ms = encode_ms(ckpt / "tokenizer.json")

    data, logs = work / "data_cli", work / "cli_logs"
    env = {"LLM_PROVIDER": "local", "LLM_CHECKPOINT": str(ckpt), "LLM_DTYPE": "bfloat16",
           "LLM_MAX_NEW_TOKENS": str(LLM_SMOKE_NEW_TOKENS)}
    saved = {k: os.environ.get(k) for k in (*env, "FRAG_PLATFORM")}
    built = []
    build = Runtime.build.__func__

    def recording_build(cls, *a, **kw):
        rt = build(cls, *a, **kw)
        built.append(rt)
        return rt

    plan = [("ingest_all", ["--dir", work / "extracted", "--data-dir", data]),
            ("check_collections", ["--data-dir", data]),
            ("test_full_flow", ["--data-dir", data, "--log-dir", logs]),
            ("pc_retrieval_smoke", ["--data-dir", data]),
            ("pc_llm_answer", ["--dir", work / "extracted", "--data-dir", data,
                               "--log-dir", logs]),
            ("recall_eval", ["--out", logs / "RECALL.json"])]
    outputs, seconds, runtimes = {}, {}, {}
    os.environ.update(env)
    os.environ.pop("FRAG_PLATFORM", None)       # the scripts' default device: the card
    Runtime.build = classmethod(recording_build)
    reset_launches()
    try:
        for name, argv in plan:
            n_built = len(built)
            rc, outputs[name], seconds[name] = run_cli_script(name, argv)
            check(rc == 0, f"cli: {name} returned {rc}: {outputs[name][-800:]}")
            runtimes[name] = built[n_built:]
        launches = read_launches()
    finally:
        Runtime.build = classmethod(build)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check_path_launched(CLI_PATH, launches, "cli path")
    for name, rts in runtimes.items():
        check(all(rt.device.type == "cuda" for rt in rts),
              f"cli: {name} built a runtime on {[str(rt.device) for rt in rts]}")

    # check_collections counts what ingest_all reported
    def counts(text, pattern):
        return [int(m.replace(",", "")) for m in re.findall(pattern, text)]
    ingested, checked = outputs["ingest_all"], outputs["check_collections"]
    n_docs = len(list((work / "extracted").glob("*.json")))
    check(f"ingested {n_docs} documents (0 failed)" in ingested,
          f"cli: ingest_all: {ingested[-400:]}")
    vectors = counts(ingested, r"collection \S+: (\d+) vectors")
    parents = counts(ingested, r"parents\.db: (\d+) parents")
    check(len(vectors) == 2 and vectors[0] == vectors[1] >= MIN_CHILDREN and parents,
          f"cli: ingest_all's counts {vectors} {parents}")
    check(counts(checked, r": (\d+) vectors \(capacity") == vectors
          and counts(checked, r"parents\.db: (\d+) parents") == parents
          and counts(checked, r"children_meta\.db: (\d+) children") == vectors[:1],
          f"cli: check_collections does not count what ingest_all reported: {checked}")

    # the local LLM loaded, and every answer is the model's
    answers = []
    for name, pattern in (("test_full_flow", "fullflow_*.json"),
                          ("pc_llm_answer", "qa_llm_payload_*.json")):
        llm = getattr(runtimes[name][0].engine.llm, "inner", None)
        check(isinstance(llm, LocalLLM) and llm.available() and not llm._failed,
              f"cli: {name}'s LLM is {type(llm).__name__}, loaded "
              f"{getattr(llm, '_loaded', None)}, failed {getattr(llm, '_failed', None)}")
        check(llm._tok.__class__ is HFTokenizer and llm._chat == "chatml",
              f"cli: {name}'s LLM reads its tokenizer with {type(llm._tok).__name__}, "
              f"template {llm._chat}")
        found = [json.loads(f.read_text())["answer"] for f in sorted(logs.glob(pattern))]
        check(len(found) == 5, f"cli: {name} wrote {len(found)} answers")
        for a in found:
            check(bool(a) and not a.startswith(DEGRADED), f"cli: {name}: degraded answer {a!r:.160}")
        answers += found
    check("parent " in outputs["pc_retrieval_smoke"], "cli: pc_retrieval_smoke found no parent")
    recall = json.loads(outputs["recall_eval"].strip().splitlines()[-1])
    check(recall["backend"] == "cuda" and 0.0 < recall["value"] <= 1.0,
          f"cli: recall_eval {recall}")
    emit({"phase": "cli", "seconds": time.perf_counter() - t_phase,
          "script_s": seconds, "children": vectors[0], "parents": parents[0],
          "tokenizer": "byte-level BPE fixture qwen2_style, padded to "
                       f"{QWEN2_05B['vocab_size']} ids", "probes": probes,
          "reader_first_load_s": reader_load_s,
          "encode_prompt_tokens": prompt_tokens, "encode_first_ms": encode_first_ms,
          "encode_ms": encode_steady_ms, "recall_eval_value": recall["value"],
          "recall_eval_n_chunks": recall["n_chunks"], "answers": len(answers),
          "answer_sample": answers[0][:160], "launches": launches})
    built.clear()
    runtimes.clear()
    torch.cuda.empty_cache()
    return launches


def phase_llm_profile(torch, rt):
    """The llm runtime under the profiler, 2 questions: each generation is
    tens of eager verify steps of ~1,450 kernels, so more would flood the
    profiler."""
    port = phase_profile(torch, rt, label="llm", n_questions=2)
    check(any(n.startswith("causal_fwd_") for n in port), f"the profile saw no K9: {port}")


def phase_decoder_parity(torch, rt, ckpt: Path):
    """The same 0.5B weights through the port on the CPU (f32, K9's plain
    version) against the card (bf16, K9) on one ~256-token left-padded
    answer prompt. Two gates: the last-position logits' cosine (bf16
    activations through 24 layers drift by more than a fixed tolerance
    would allow on 151,936 logits) and, for each layer, the cosine of K9's
    output on the real rows, where the kernel's share is direct. Controls
    run the card's prefill with K9 replaced by zeros, by K9 ignoring
    pad_len, with the first real key tile lost, with the two kv heads
    swapped, and with the mask one key off (pad_len - 1); each must fail a
    gate, or the gates could not tell a wrong K9 from a right one. Top-1
    agreement is reported, not gated."""
    import numpy as np

    from financial_rag_tpu_torch.llm.local_llm import _load_state_dict
    from financial_rag_tpu_torch.models import decoder

    llm = rt.engine.llm.inner      # the LocalLLM inside the BatchingLLM
    dcfg = llm._dcfg
    ids = llm._tok.encode(llm._wrap(GOLDEN_CORPUS["lease_2022"] + " " + GOLDEN_QUESTIONS[0])).ids
    ids = (ids * 4)[-200:]
    s, pad = 256, 256 - len(ids)
    input_ids = np.full((1, s), dcfg.eos_token_id, np.int64)
    mask = np.zeros((1, s), np.int32)
    input_ids[0, pad:], mask[0, pad:] = ids, 1
    torch.set_num_threads(max(os.cpu_count() or 1, 1))
    cpu_params = decoder.decoder_params_from_torch_state_dict(
        _load_state_dict(ckpt), dcfg, dtype=torch.float32, device="cpu")
    k9 = decoder.causal_flash_prefill

    def prefill(params, dev, attend):
        """Last-position logits and each layer's attention on the real rows."""
        attn = []

        def recorded(q, k, v, pad_len, **kw):
            out = attend(q, k, v, pad_len, **kw)
            attn.append(out[0, pad:].float().cpu().flatten())
            return out

        decoder.causal_flash_prefill = recorded
        try:
            with torch.inference_mode():
                logits = decoder._prefill(params, torch.from_numpy(input_ids).to(dev),
                                          torch.from_numpy(mask).to(dev), s, dcfg)[0][0]
        finally:
            decoder.causal_flash_prefill = k9
        return logits.float().cpu(), torch.stack(attn)

    def swap_kv(t):
        return t.view(1, s, dcfg.num_kv_heads, -1).flip(2).reshape(1, s, -1).contiguous()

    controls = {
        "zeros": lambda q, k, v, p, **kw: torch.zeros_like(q),
        "pad_ignored": lambda q, k, v, p, **kw: k9(q, k, v, torch.zeros_like(p), **kw),
        "first_key_tile_lost": lambda q, k, v, p, **kw: k9(q, k, v, p + 64, **kw),
        "kv_heads_swapped": lambda q, k, v, p, **kw: k9(q, swap_kv(k), swap_kv(v), p, **kw),
        "mask_one_key_off": lambda q, k, v, p, **kw: k9(q, k, v, p - 1, **kw),
    }
    want, want_attn = prefill(cpu_params, "cpu", k9)

    def readings(attend):
        got, attn = prefill(llm._params, llm.device, attend)
        layer_cos = torch.nn.functional.cosine_similarity(attn, want_attn, dim=1)
        return got, {"logits_cosine": float(torch.nn.functional.cosine_similarity(got, want, dim=0)),
                     "attention_cosine_min": float(layer_cos.min()),
                     "attention_cosine_layer0": float(layer_cos[0])}

    def passes(r):
        return (r["logits_cosine"] >= DECODER_LOGITS_COSINE
                and r["attention_cosine_min"] >= DECODER_ATTENTION_COSINE)

    got, real = readings(k9)
    ctrl = {name: readings(fn)[1] for name, fn in controls.items()}
    out = {"phase": "decoder_parity", "prompt_tokens": len(ids), "bucket": s, "pad": pad, **real,
           "bars": {"logits_cosine": DECODER_LOGITS_COSINE,
                    "attention_cosine_min": DECODER_ATTENTION_COSINE},
           "top1_agree": int(got.argmax()) == int(want.argmax()),
           "max_abs_err": float((got - want).abs().max()),
           "logit_range": [float(want.min()), float(want.max())], "controls": ctrl}
    emit(out)
    check(passes(real), f"decoder parity between the card and the CPU: {real}")
    seen = [n for n, r in ctrl.items() if passes(r)]
    check(not seen, f"decoder parity: the controls {seen} pass the gates, which cannot see them")


# ------------------------------------------------------------- training

# Card (bf16, K2/K10/K3) against CPU (f32, plain versions) gradient parity
# (phase_train_parity): the cosine each leaf group's gradient must reach.
# Each sits between the right kernels' reading and the controls' (PERF.md).
TRAIN_GRAD_COSINE = 0.999
# The loss's bar, |card - CPU|: about ten times the forward's (K2, K3)
# readings (PERF.md). The K10 controls change only the backward, so their
# losses equal the right kernels' and the cosines gate them.
TRAIN_LOSS_TOL = 1e-3
GRAD_GROUPS = {
    "embeddings": ("embeddings/word", "embeddings/position", "embeddings/token_type"),
    "q": ("layers/q_w", "layers/q_b"),
    "k": ("layers/k_w",),   # k_b: softmax ignores a shift of every score, its gradient is 0
    "v": ("layers/v_w", "layers/v_b"),
    "o": ("layers/o_w", "layers/o_b"),
    "ffn": ("layers/ffn_in_w", "layers/ffn_in_b", "layers/ffn_out_w", "layers/ffn_out_b"),
    "layer_norms": ("embeddings/ln_scale", "embeddings/ln_bias", "layers/attn_ln_scale",
                    "layers/attn_ln_bias", "layers/ffn_ln_scale", "layers/ffn_ln_bias"),
}


def padded_pair_batch(rng, b: int, s: int, vocab: int = 30000) -> dict:
    """Seeded random ids; each side's rows have random lengths (row 0 full,
    the shortest 8 tokens)."""
    import numpy as np

    out = {}
    for side in ("q", "d"):
        lens = rng.integers(8, s + 1, size=b)
        lens[0], lens[-1] = s, 8
        out[f"{side}_ids"] = rng.integers(5, vocab, size=(b, s)).astype(np.int32)
        out[f"{side}_mask"] = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return out


def listwise_batch(rng, groups: int, g: int, s: int, vocab: int = 30000) -> dict:
    """Seeded [groups, g, s] listwise batch: each row padded to a random
    length of 8 to s tokens, its second half segment 1."""
    import numpy as np

    lens = rng.integers(8, s + 1, size=(groups, g))
    mask = (np.arange(s)[None, None, :] < lens[:, :, None]).astype(np.int32)
    return {"ids": rng.integers(5, vocab, size=(groups, g, s)).astype(np.int32), "mask": mask,
            "types": ((np.arange(s)[None, None, :] >= lens[:, :, None] // 2) * mask)
            .astype(np.int32)}


def check_train_launches(launches: dict, steps: int, layers: int, encodes: int, what: str):
    """K2, K10 and K3 each launched once per layer of every encode of every
    step; K1 never (training pools with the plain mean)."""
    want = steps * layers * encodes
    got = {k: launches[k] for k in TRAIN_PATH}
    check(all(v == want for v in got.values()),
          f"{what}: K2/K10/K3 launches {got}, want {want} each")
    check(launches["masked_mean_l2_normalize"] == 0,
          f"{what}: K1 launched {launches['masked_mean_l2_normalize']} times in training")


def run_steps(torch, step, params, opt_state, batch, *, warmup: int, steps: int, what: str):
    """``warmup`` + ``steps`` train steps on one batch; each step's time by
    CUDA events (bench_train.time_steps). Checks every loss is finite and
    that the parameters moved."""
    from financial_rag_tpu_torch.scripts.bench_train import time_steps

    watched = params["layers"]["q_w"]
    before = watched.detach().clone()
    losses = []

    def run():
        _, _, loss = step(params, opt_state, batch)
        losses.append(loss)

    ms = time_steps(run, torch.device("cuda"), warmup=warmup, steps=steps)
    losses = [float(x) for x in losses]
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"{what}: a loss is not finite: {losses}")
    moved = (watched.detach() - before).abs().max().item()
    check(moved > 0, f"{what}: the parameters did not move")
    return ms, losses, moved


def phase_train(torch, seed: int):
    """Fine-tuning at full width, bf16 compute with f32 master weights:
    (1) contrastive steps of make_train_step at the bge-small shape, 256
    pairs x 2 x 128 tokens (the JAX bench's batch: seeded random ids, no
    padding), 3 warm-up and 10 timed; (2) listwise steps of
    make_rerank_train_step at the MiniLM-L-6 shape, 64 groups x 4 x 64
    tokens, 1 warm-up and 5 timed; (3) one contrastive step under the
    profiler; (4) the retrieval uplift with train_uplift's defaults (200
    steps of 256 pairs at S=32, lr 3e-4, 64 concepts, 2,048 / 256 pairs),
    held to the JAX package's bar, uplift >= 0.5; its eval runs the serving
    path (K1, K2, K3, K4). Returns the contrastive steps' launches."""
    import numpy as np

    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.scripts.bench_train import bge_small_config, random_pair_batch
    from financial_rag_tpu_torch.training import make_rerank_train_step, make_train_step
    from financial_rag_tpu_torch.training.uplift import measure_retrieval_uplift

    dev = torch.device("cuda")
    cfg = bge_small_config()
    step, init_state = make_train_step(cfg, device=dev)
    check(step.compute_dtype == torch.bfloat16, "the train step does not compute in bf16")
    params, opt_state = init_state(random_params(cfg, seed=seed))
    check(all(t.dtype == torch.float32 for g in params.values() for t in g.values()),
          "the master weights are not float32")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in random_pair_batch(256, 128, seed).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, losses, moved = run_steps(torch, step, params, opt_state, batch, warmup=3, steps=10,
                                  what="contrastive")
    launches = read_launches()
    check_train_launches(launches, 13, cfg.num_layers, 2, "contrastive")
    contrastive = {"shape": "bge-small (12L h384), 256 pairs x 2 x 128, bf16 / f32 masters",
                   "step_ms_median": statistics.median(ms), "step_ms": ms,
                   "pairs_per_s": 256 / statistics.median(ms) * 1e3,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "loss_first": losses[0], "loss_last": losses[-1],
                   "max_param_move": moved, "launches": launches}

    def one_step(attempt):
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prof, wall_ms = profiled(torch, one_step, with_cpu=True)
    step_profile = device_profile(prof, wall_ms)
    del params, opt_state, batch, step
    torch.cuda.empty_cache()

    rcfg = bge_small_config(layers=6, num_labels=1)
    rstep, rinit = make_rerank_train_step(rcfg, device=dev)
    rparams, ropt = rinit(random_params(rcfg, seed=seed + 1))
    rbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in listwise_batch(np.random.default_rng(seed), 64, 4, 64).items()}
    reset_launches()
    rms, rlosses, rmoved = run_steps(torch, rstep, rparams, ropt, rbatch, warmup=1, steps=5,
                                     what="listwise")
    rlaunches = read_launches()
    check_train_launches(rlaunches, 6, rcfg.num_layers, 1, "listwise")
    listwise = {"shape": "MiniLM-L-6 (6L h384, 1 label), 64 groups x 4 x 64, bf16 / f32 masters",
                "step_ms_median": statistics.median(rms), "step_ms": rms,
                "loss_first": rlosses[0], "loss_last": rlosses[-1],
                "max_param_move": rmoved, "launches": rlaunches}
    del rparams, ropt, rbatch, rstep
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.perf_counter()
    rep = measure_retrieval_uplift(cfg, device=dev, steps=200, batch_size=256, lr=3e-4,
                                   seq_len=32, k=10, n_concepts=64, n_train=2048, n_eval=256,
                                   seed=seed)
    uplift_s = time.perf_counter() - t0
    ulaunches = read_launches()
    check_path_launched(("masked_mean_l2_normalize", "packed_topk_fused", *TRAIN_PATH),
                        ulaunches, "uplift")
    emit({"phase": "train", "contrastive": contrastive, "listwise": listwise,
          "contrastive_step_profile": step_profile,
          "uplift": {**rep, "wall_s": uplift_s, "launches": ulaunches}})
    check(rep["uplift"] >= 0.5, f"retrieval uplift {rep['uplift']} < 0.5: {rep}")
    return launches


def grad_groups(torch, got, want):
    """(group, card vector, CPU vector) for each leaf group: every layer's
    leaves of the group flattened into one float64 vector (f32 sums of ~10M
    terms drift)."""
    for group, names in GRAD_GROUPS.items():
        a, b = [], []
        for name in names:
            g, n = name.split("/")
            a.append(got[g][n].float().cpu().flatten())
            b.append(want[g][n].float().flatten())
        yield group, torch.cat(a).double(), torch.cat(b).double()


def grad_group_cosines(torch, got, want) -> dict:
    """Cosine between the card's and the CPU's gradient of each leaf group."""
    out = {}
    for group, a, b in grad_groups(torch, got, want):
        norms = float(a.norm() * b.norm())
        out[group] = float(a @ b) / norms if norms > 0 else 0.0   # a zero gradient: 0
    return out


def grad_group_norm_ratios(torch, got, want) -> dict:
    """||card|| / ||CPU|| of each leaf group's gradient."""
    return {group: float(a.norm()) / float(b.norm()) if float(b.norm()) > 0 else 0.0
            for group, a, b in grad_groups(torch, got, want)}


def phase_train_parity(torch, seed: int, cfg=None, phase: str = "train_parity"):
    """One contrastive step's loss and gradients on the same seeded
    bge-small-shape weights (or ``cfg``'s) and padded batch (8 pairs x 128
    tokens): on the card in bf16 (K2, K10, K3) and on the CPU in f32 (the
    plain versions). Each leaf group's gradient cosine must reach
    TRAIN_GRAD_COSINE. The controls rerun the card's step with K10 wrong:
    its dQ zeroed, dK and dV swapped between heads 0 and 1, the padding
    mask ignored in the backward; each must fail a gate, or the gates could
    not tell a wrong K10 from a right one. Returns the CPU step's loss and
    gradients, the reference of phase_train_tp's parity, and the card
    step's loss and gradients (on the CPU)."""
    import numpy as np

    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.ops import flash_attention as fa
    from financial_rag_tpu_torch.scripts.bench_train import bge_small_config
    from financial_rag_tpu_torch.training import make_train_step

    cfg = cfg or bge_small_config()
    params = random_params(cfg, seed=seed + 2)
    batch = padded_pair_batch(np.random.default_rng(seed + 2), 8, 128)
    card, card_init = make_train_step(cfg, device="cuda")
    cpu, cpu_init = make_train_step(cfg, device="cpu")
    card_params, _ = card_init(params)
    cpu_params, _ = cpu_init(params)
    torch.set_num_threads(max(os.cpu_count() or 1, 1))
    want_loss, want = cpu.value_and_grad(cpu_params, batch)
    k10 = fa.flash_attention_bwd

    def readings(backward, keep=False):
        fa.flash_attention_bwd = backward
        try:
            reset_launches()
            loss, grads = card.value_and_grad(card_params, batch)
            torch.cuda.synchronize()
        finally:
            fa.flash_attention_bwd = k10
        kept = ({g: {n: t.float().cpu() for n, t in leaves.items()} for g, leaves in grads.items()}
                if keep else None)
        return float(loss), grads_cos(grads), read_launches(), kept

    def grads_cos(grads):
        return grad_group_cosines(torch, grads, want)

    def swap_heads(t):
        b, s, h = t.shape
        t = t.view(b, s, cfg.num_heads, h // cfg.num_heads).clone()
        t[:, :, [0, 1]] = t[:, :, [1, 0]]
        return t.view(b, s, h)

    def dq_zeroed(q, k, v, bias, dout, **kw):
        dq, dk, dv = k10(q, k, v, bias, dout, **kw)
        return torch.zeros_like(dq), dk, dv

    def dk_dv_heads_swapped(q, k, v, bias, dout, **kw):
        dq, dk, dv = k10(q, k, v, bias, dout, **kw)
        return dq, swap_heads(dk), swap_heads(dv)

    def mask_ignored(q, k, v, bias, dout, **kw):
        return k10(q, k, v, torch.zeros_like(bias), dout, **kw)

    loss, real, launches, card_grads = readings(k10, keep=True)
    check(launches["flash_attention_bwd"] == 2 * cfg.num_layers,
          f"{phase}: {launches['flash_attention_bwd']} K10 launches for one step")
    control_runs = {name: readings(fn)[:2] for name, fn in (("dq_zeroed", dq_zeroed),
                                                            ("dk_dv_heads_swapped", dk_dv_heads_swapped),
                                                            ("mask_ignored", mask_ignored))}
    controls = {name: cos for name, (_, cos) in control_runs.items()}
    emit({"phase": phase, "shape": f"{cfg.num_layers}L h{cfg.hidden_size}, "
          f"{cfg.num_heads} heads of {cfg.hidden_size // cfg.num_heads}", "pairs": 8, "seq": 128,
          "live_tokens": int(batch["q_mask"].sum() + batch["d_mask"].sum()),
          "loss_card": loss, "loss_cpu": float(want_loss), "loss_tol": TRAIN_LOSS_TOL,
          "grad_cosine": real, "bar": TRAIN_GRAD_COSINE, "controls": controls,
          "control_losses": {name: cl for name, (cl, _) in control_runs.items()}})

    def passes(r):
        return all(v >= TRAIN_GRAD_COSINE for v in r.values())

    check(abs(loss - float(want_loss)) <= TRAIN_LOSS_TOL,
          f"{phase}: loss {loss} vs {float(want_loss)}")
    check(passes(real), f"{phase}: gradient cosines {real}")
    seen = [n for n, r in controls.items() if passes(r)]
    check(not seen, f"{phase}: the controls {seen} pass the gates, which cannot see them")
    return float(want_loss), want, loss, card_grads


# ------------------------------------------------------- tensor parallel

TP_WORLD = 4
# Card (bf16, K11 on dp2 x tp2) against CPU (f32, one process) gradients: the
# cosine bar of phase_train_parity, and each leaf group's norm ratio within
# 1 +- TP_GRAD_NORM_TOL. The ratio sees what the cosine cannot: a data
# all-reduce that averages where it must sum scales every gradient by 1/dp.
TP_GRAD_NORM_TOL = 0.01
# The size of each train_tp run: full width and depth; a CPU rehearsal passes
# a smaller plan.
TP_PLAN = {"device": "cuda", "layers": 12, "rerank_layers": 6, "contrastive": (64, 128),
           "listwise": (32, 4, 64), "parity": (8, 128), "warmup": 1, "steps": 3}
# The timeout of every train_tp collective (the default group's and the meshes')
TP_TIMEOUT_S = 300
def _replicated_digests(params, mesh) -> dict:
    """sha256 of every replicated leaf's bytes (the sharding rules' None)."""
    import hashlib

    from financial_rag_tpu_torch.training import param_sharding_rules

    rules = param_sharding_rules(mesh)
    return {f"{g}/{n}": hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
            for g, leaves in params.items() for n, t in leaves.items()
            if rules.get(g, {}).get(n) is None}


def train_tp_rank(rank, world, device, seed, plan):
    """One rank of phase_train_tp, started by parallel.launch.spawn: the
    three timed runs (launch counts set to 0 just before each and read just
    after) and the parity step with its controls. Returns what the parent
    checks; only rank 0 returns gradients (gathered over the model axis)."""
    import numpy as np
    import torch

    from financial_rag_tpu_torch.models import bert
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.parallel import comm, train_mesh
    from financial_rag_tpu_torch.scripts.bench_train import (bge_small_config, random_pair_batch,
                                                             time_steps)
    from financial_rag_tpu_torch.training import (contrastive, gather_params,
                                                  make_rerank_train_step, make_train_step)

    cuda = device.type == "cuda"
    out = {"rank": rank, "device": str(device)}

    def timed(name, tp, cfg, make, batch, encodes):
        mesh = train_mesh(tp, timeout_s=TP_TIMEOUT_S)
        step, init_state = make(cfg, mesh, device=device)
        params, opt_state = init_state(random_params(cfg, seed=seed))
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        losses = []

        def run():
            _, _, loss = step(params, opt_state, batch)
            losses.append(loss)

        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        t0 = time.perf_counter()
        ms = time_steps(run, device, warmup=plan["warmup"], steps=plan["steps"])
        wall_s = time.perf_counter() - t0
        out[name] = {"mesh": dict(mesh.shape), "coords": dict(mesh.coords),
                     "attention_impl": step.attention_impl, "layers": cfg.num_layers,
                     "encodes": encodes, "steps": plan["warmup"] + plan["steps"],
                     "launches": read_launches(), "step_ms": ms, "wall_s": wall_s,
                     "losses": [float(x) for x in losses],
                     "replicated": _replicated_digests(params, mesh),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None}

    cfg = bge_small_config(plan["layers"])
    pairs, seq = plan["contrastive"]
    timed("contrastive_dp2_tp2", 2, cfg, make_train_step, random_pair_batch(pairs, seq, seed), 2)
    timed("contrastive_dp1_tp4", 4, cfg, make_train_step, random_pair_batch(pairs, seq, seed), 2)
    groups, g, rseq = plan["listwise"]
    timed("listwise_dp2_tp2", 2, bge_small_config(plan["rerank_layers"], num_labels=1),
          make_rerank_train_step, listwise_batch(np.random.default_rng(seed), groups, g, rseq), 1)

    # parity: phase_train_parity's weights and batch, one step's gradients
    mesh = train_mesh(2, timeout_s=TP_TIMEOUT_S)
    step, init_state = make_train_step(cfg, mesh, device=device)
    params, _ = init_state(random_params(cfg, seed=seed + 2))
    batch = padded_pair_batch(np.random.default_rng(seed + 2), *plan["parity"])
    k11, copy, sync = bert.flash_attention_tp, comm.copy_to_model, contrastive.sync_grads
    n, m = mesh.shape["model"], mesh.index("model")

    def neighbour_kv(q, k, v, bias, **kw):
        w, nb = k.shape[-1], (m + 1) % n
        k, v = (comm.all_gather(t.float(), mesh, "model", dim=2)[..., nb * w:(nb + 1) * w]
                .to(t.dtype).contiguous() for t in (k, v))
        return k11(q, k, v, bias, **kw)

    def copy_without_allreduce(x, mesh, axis="model"):
        return x

    parity = {}

    def grads(name):
        reset_launches()
        loss, tree = step.value_and_grad(params, batch)
        launches = read_launches()
        full = gather_params(tree, mesh)
        parity[name] = {"loss": float(loss), "launches": launches,
                        "grads": ({gk: {k: t.float().cpu() for k, t in gv.items()}
                                   for gk, gv in full.items()} if rank == 0 else None)}

    grads("right")
    try:
        bert.flash_attention_tp = neighbour_kv
        grads("neighbour_kv")
        bert.flash_attention_tp, comm.copy_to_model = k11, copy_without_allreduce
        grads("copy_without_allreduce")
        comm.copy_to_model = copy
        contrastive.sync_grads = lambda g, mesh, axis, op: sync(g, mesh, axis, "mean")
        grads("data_mean")
    finally:
        bert.flash_attention_tp, comm.copy_to_model, contrastive.sync_grads = k11, copy, sync
    out["parity"] = parity
    return out


def k11_failures(name: str, r: dict, want_k11: int):
    """A TP run's failures on one rank: K11's forward and backward each
    launched ``want_k11`` times, K3 and K1 never, the pallas_tp attention.
    Returns (its K11 forward and backward launches, failures)."""
    got = {k: r["launches"][k] for k in ("flash_attention_tp", "flash_attention_tp_bwd",
                                         "fused_ffn", "masked_mean_l2_normalize")}
    failures = []
    if not got["flash_attention_tp"] == got["flash_attention_tp_bwd"] == want_k11:
        failures.append(f"{name}: K11 launches {got} on rank {r['coords']}, want {want_k11}")
    if got["fused_ffn"] or got["masked_mean_l2_normalize"]:
        failures.append(f"{name}: K3 or K1 launched: {got}")
    if r["attention_impl"] != "pallas_tp":
        failures.append(f"{name}: attention {r['attention_impl']}")
    return (got["flash_attention_tp"], got["flash_attention_tp_bwd"]), failures


def phase_train_tp(torch, seed: int, info: dict, want_loss: float, want, plan=TP_PLAN):
    """Data- and tensor-parallel training through K11: 4 ranks started by
    parallel.launch.spawn after the kernels are built (on one card they
    share it over gloo, which moves every collective through the host; with
    4 cards, one each over NCCL). Contrastive steps of the bge-small shape,
    64 pairs x 2 x 128 tokens, on dp2 x tp2 and on dp1 x tp4; listwise
    steps of the MiniLM-L-6 shape, 32 groups x 4 x 64, on dp2 x tp2; each 1
    warm-up and 3 timed. Gates: K11's forward and backward launched once
    per layer, encode and step on every rank, K3 and K1 never; every loss
    finite; the replicated leaves bit-identical on the TP ranks of each
    data row after the steps. Parity: one step's gradients on dp2 x tp2
    (phase_train_parity's weights and 8 padded pairs x 128), gathered,
    against the CPU f32 single-process step: loss within TRAIN_LOSS_TOL,
    each leaf group's cosine >= TRAIN_GRAD_COSINE and norm ratio within 1 +-
    TP_GRAD_NORM_TOL; K11 fed the model neighbour's k/v heads,
    copy_to_model without its backward all-reduce, and a data all-reduce
    that averages must each fail. Returns K11's forward and backward
    launches over the three runs and all ranks."""
    from financial_rag_tpu_torch.parallel import launch

    backend, n_gpus = launch.choose_backend(TP_WORLD, plan["device"])
    label = (f"{TP_WORLD} ranks sharing one {info['name']} over gloo" if backend == "gloo"
             else f"{TP_WORLD} ranks over {backend}, {n_gpus} GPUs")
    if plan["device"] == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(train_tp_rank, TP_WORLD, args=(seed, plan), device=plan["device"],
                         timeout_s=TP_TIMEOUT_S, join_timeout_s=900)
    spawn_s = time.perf_counter() - t0

    runs, k11, failures = {}, [0, 0], []
    for name in ("contrastive_dp2_tp2", "contrastive_dp1_tp4", "listwise_dp2_tp2"):
        per = [r[name] for r in ranks]
        want_k11 = per[0]["layers"] * per[0]["encodes"] * per[0]["steps"]
        for r in per:
            (fwd, bwd), fails = k11_failures(name, r, want_k11)
            failures += fails
            if not all(math.isfinite(x) for x in r["losses"]):
                failures.append(f"{name}: losses {r['losses']}")
            k11[0] += fwd
            k11[1] += bwd
        first_of_row: dict = {}
        differ = set()
        for r in per:
            ref = first_of_row.setdefault(r["coords"]["data"], r["replicated"])
            differ |= {leaf for leaf, h in r["replicated"].items() if ref[leaf] != h}
        if differ:
            failures.append(f"{name}: replicated leaves differ between the TP ranks of a data "
                            f"row: {sorted(differ)}")
        ms = [statistics.median(r["step_ms"]) for r in per]
        runs[name] = {"mesh": per[0]["mesh"], "timing": label,
                      "step_ms_median_by_rank": ms, "step_ms": [r["step_ms"] for r in per],
                      "wall_s_by_rank": [r["wall_s"] for r in per],
                      "losses": per[0]["losses"],
                      "losses_equal_on_all_ranks": all(r["losses"] == per[0]["losses"] for r in per),
                      "replicated_leaves": len(per[0]["replicated"]),
                      "replicated_differ_in_a_data_row": sorted(differ),
                      "replicated_equal_on_all_ranks": all(r["replicated"] == per[0]["replicated"]
                                                          for r in per),
                      "peak_memory_bytes_by_rank": [r["peak_memory_bytes"] for r in per],
                      "k11_launches_per_rank": want_k11}

    parity = {}
    for name, r in ranks[0]["parity"].items():
        parity[name] = {"loss": r["loss"],
                        "cosine": grad_group_cosines(torch, r["grads"], want),
                        "norm_ratio": grad_group_norm_ratios(torch, r["grads"], want),
                        "k11_launches": r["launches"]["flash_attention_tp"]}

    def passes(r):
        return (abs(r["loss"] - want_loss) <= TRAIN_LOSS_TOL
                and all(c >= TRAIN_GRAD_COSINE for c in r["cosine"].values())
                and all(abs(x - 1) <= TP_GRAD_NORM_TOL for x in r["norm_ratio"].values()))

    emit({"phase": "train_tp", "world": TP_WORLD, "backend": backend, "timing": label,
          "card": info["nvidia_smi"], "spawn_s": spawn_s,
          "runs": runs, "parity": {"loss_cpu": want_loss, "loss_tol": TRAIN_LOSS_TOL,
                                   "cosine_bar": TRAIN_GRAD_COSINE,
                                   "norm_ratio_tol": TP_GRAD_NORM_TOL, **parity},
          "k11_launches": k11[0], "k11_bwd_launches": k11[1]})
    check(not failures, "train_tp: " + "; ".join(failures))
    check(parity["right"]["k11_launches"] == 2 * plan["layers"],
          f"train_tp parity: {parity['right']['k11_launches']} K11 launches for one step")
    check(passes(parity["right"]), f"train_tp parity: {parity['right']}")
    seen = [n for n, r in parity.items() if n != "right" and passes(r)]
    check(not seen, f"train_tp parity: the controls {seen} pass the gates, which cannot see them")
    return k11


# ------------------------------------------------- the bge-base width, trained

# The size of each train_wide run: full width and depth for the timed steps;
# the gradient parity and the TP step at 2 layers of full width (the CPU's
# f32 step at 12 layers would take minutes); a CPU rehearsal passes less.
WIDE_TRAIN_PLAN = {"device": "cuda", "layers": 12, "rerank_layers": 12, "contrastive": (256, 128),
                   "listwise": (64, 4, 64), "warmup": 1, "steps": 3, "parity_layers": 2,
                   "parity": (8, 128), "tps": (2, 4), "feedback_steps": 4, "feedback_batch": 8,
                   "feedback_seq": 128, "uplift": ["--hidden", "768", "--steps", "20",
                                                  "--train", "512", "--eval", "128"]}


def train_tp_wide_rank(rank, world, device, seed, plan):
    """One rank of phase_train_wide's TP step: at 2 layers of the bge-base
    width, on dp2 x tp2 (6 local heads of 64) and dp1 x tp4 (3 local heads
    of 64), one step's gradients (gathered; rank 0 returns them) on
    phase_train_parity's weights and batch, then a whole step. Launch
    counts set to 0 just before each mesh's step and read just after."""
    import numpy as np
    import torch

    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.parallel import train_mesh
    from financial_rag_tpu_torch.scripts.bench_train import bge_base_config
    from financial_rag_tpu_torch.training import gather_params, make_train_step

    cfg = bge_base_config(plan["parity_layers"])
    batch = padded_pair_batch(np.random.default_rng(seed + 2), *plan["parity"])
    out = {"rank": rank}
    for tp in plan["tps"]:
        mesh = train_mesh(tp, timeout_s=TP_TIMEOUT_S)
        step, init_state = make_train_step(cfg, mesh, device=device)
        params, opt_state = init_state(random_params(cfg, seed=seed + 2))
        reset_launches()
        loss, tree = step.value_and_grad(params, batch)
        full = gather_params(tree, mesh)
        _, _, step_loss = step(params, opt_state, batch)
        out[f"dp{world // tp}_tp{tp}"] = {
            "mesh": dict(mesh.shape), "coords": dict(mesh.coords),
            "attention_impl": step.attention_impl, "loss": float(loss),
            "step_loss": float(step_loss), "launches": read_launches(),
            "grads": ({g: {k: t.float().cpu() for k, t in leaves.items()}
                       for g, leaves in full.items()} if rank == 0 else None)}
    return out


def seed_feedback_db(path: Path) -> int:
    """A feedback database as the engine leaves it: each golden question's
    result cached with three passages of the golden corpus (its sentences),
    and a rating: 5 for the even questions, 1 for the odd ones (their
    passages become hard negatives). Returns the number of ratings."""
    from financial_rag_tpu_torch.store.feedback_db import FeedbackDatabase

    sentences = [t.strip() + "." for text in GOLDEN_CORPUS.values()
                 for t in dict.fromkeys(text.split(". ")) if t.strip()]
    db = FeedbackDatabase(path)
    for i, question in enumerate(GOLDEN_QUESTIONS):
        chunks = [{"text": sentences[(3 * i + j) % len(sentences)]} for j in range(3)]
        db.cache_put(f"smoke-{i}", question, {"top_children_chunks": chunks})
        db.store_feedback(query=question, rating=5 if i % 2 == 0 else 1)
    db.flush_writes()
    return len(GOLDEN_QUESTIONS)


def run_script(main, argv) -> dict:
    """A port script's main(argv), which prints one JSON line: that line."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0, f"{main.__module__} {argv} exited {rc}: {line}")
    return line


def phase_train_wide(torch, seed: int, info: dict, plan=WIDE_TRAIN_PLAN):
    """Training at the bge-base width (hidden 768, 12 heads of 64, FFN
    3,072), bf16 on f32 masters: (1) contrastive steps of make_train_step at
    full depth, 256 pairs x 2 x 128, 1 warm-up and 3 timed (K2 at 64, K3's
    768 design, K10 at 64, 24 of each a step); (2) listwise steps of a
    12-layer bge-base-width cross-encoder, 64 groups x 4 x 64; (3) card vs
    CPU gradients at 2 layers of full width (phase_train_parity's gates
    and wrong-K10 controls); (4) one TP step at that size on dp2 x tp2 and
    dp1 x tp4 (4 ranks over gloo, K11 at 6 and 3 local heads of 64) against
    the single-GPU card step: loss within TRAIN_LOSS_TOL, each leaf group's
    cosine >= TRAIN_GRAD_COSINE and norm ratio within 1 +- TP_GRAD_NORM_TOL,
    with the CPU's readings beside them; (5) the feedback fine-tune of a
    served checkpoint: scripts/train_rerank.py --feedback-db (a seeded
    feedback.db) --model-path (a seeded 12-layer bge-base-width
    cross-encoder), then Runtime.build with its output as the reranker
    beside the bge-small encoders answers the 9 golden questions; (6)
    scripts/train_uplift.py --hidden 768 (heads of 32), whose eval index is
    768-wide f32 (K4's f32 sweep). Returns the K10 launches of (1) and
    K11's forward and backward launches of (4)."""
    import numpy as np

    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.models.checkpoint import random_params
    from financial_rag_tpu_torch.parallel import launch
    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.scripts import train_rerank, train_uplift
    from financial_rag_tpu_torch.scripts.bench_train import bge_base_config, random_pair_batch
    from financial_rag_tpu_torch.training import make_rerank_train_step, make_train_step

    dev = torch.device(plan["device"])
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    steps = plan["warmup"] + plan["steps"]

    cfg = bge_base_config(plan["layers"])
    step, init_state = make_train_step(cfg, device=dev)
    params, opt_state = init_state(random_params(cfg, seed=seed))
    pairs, seq = plan["contrastive"]
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in random_pair_batch(pairs, seq, seed).items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, losses, moved = run_steps(torch, step, params, opt_state, batch, warmup=plan["warmup"],
                                  steps=plan["steps"], what="wide contrastive")
    launches = read_launches()
    check_train_launches(launches, steps, cfg.num_layers, 2, "wide contrastive")
    contrastive = {"shape": f"bge-base ({cfg.num_layers}L h768, 12 heads of 64), {pairs} pairs "
                            f"x 2 x {seq}, bf16 / f32 masters",
                   "step_ms_median": statistics.median(ms), "step_ms": ms,
                   "pairs_per_s": pairs / statistics.median(ms) * 1e3,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else None,
                   "loss_first": losses[0], "loss_last": losses[-1], "max_param_move": moved,
                   "launches": launches}
    del params, opt_state, batch, step
    if cuda:
        torch.cuda.empty_cache()

    rcfg = bge_base_config(plan["rerank_layers"], num_labels=1)
    rstep, rinit = make_rerank_train_step(rcfg, device=dev)
    rparams, ropt = rinit(random_params(rcfg, seed=seed + 1))
    groups, g, rseq = plan["listwise"]
    rbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in listwise_batch(np.random.default_rng(seed), groups, g, rseq).items()}
    reset_launches()
    rms, rlosses, rmoved = run_steps(torch, rstep, rparams, ropt, rbatch, warmup=plan["warmup"],
                                     steps=plan["steps"], what="wide listwise")
    rlaunches = read_launches()
    check_train_launches(rlaunches, steps, rcfg.num_layers, 1, "wide listwise")
    listwise = {"shape": f"bge-base-width cross-encoder ({rcfg.num_layers}L h768, 1 label), "
                         f"{groups} groups x {g} x {rseq}, bf16 / f32 masters",
                "step_ms_median": statistics.median(rms), "step_ms": rms,
                "loss_first": rlosses[0], "loss_last": rlosses[-1], "max_param_move": rmoved,
                "launches": rlaunches}
    del rparams, ropt, rbatch, rstep
    if cuda:
        torch.cuda.empty_cache()
    emit({"phase": "train_wide", "part": "steps", "card": info["nvidia_smi"],
          "contrastive": contrastive, "listwise": listwise})

    pcfg = bge_base_config(plan["parity_layers"])
    want_loss, want, card_loss, card_grads = phase_train_parity(torch, seed, cfg=pcfg,
                                                                phase="train_wide_parity")

    if cuda:
        torch.cuda.empty_cache()
    backend, _ = launch.choose_backend(TP_WORLD, plan["device"])
    t0 = time.perf_counter()
    ranks = launch.spawn(train_tp_wide_rank, TP_WORLD, args=(seed, plan), device=plan["device"],
                         timeout_s=TP_TIMEOUT_S, join_timeout_s=900)
    spawn_s = time.perf_counter() - t0
    tp_runs, k11, failures = {}, [0, 0], []
    for name in ranks[0]:
        if name == "rank":
            continue
        want_k11 = 2 * 2 * pcfg.num_layers   # (value_and_grad + step) x 2 encodes x layers
        for r in ranks:
            (fwd, bwd), fails = k11_failures(name, r[name], want_k11)
            failures += fails
            k11[0] += fwd
            k11[1] += bwd
        r0 = ranks[0][name]
        tp_runs[name] = {"mesh": r0["mesh"], "loss": r0["loss"], "step_loss": r0["step_loss"],
                         "losses_equal_on_all_ranks": all(r[name]["loss"] == r0["loss"]
                                                          for r in ranks),
                         "cosine": grad_group_cosines(torch, r0["grads"], card_grads),
                         "norm_ratio": grad_group_norm_ratios(torch, r0["grads"], card_grads),
                         "cosine_cpu": grad_group_cosines(torch, r0["grads"], want),
                         "norm_ratio_cpu": grad_group_norm_ratios(torch, r0["grads"], want),
                         "k11_launches_per_rank": want_k11}
        run = tp_runs[name]
        if not (abs(run["loss"] - card_loss) <= TRAIN_LOSS_TOL
                and all(c >= TRAIN_GRAD_COSINE for c in run["cosine"].values())
                and all(abs(x - 1) <= TP_GRAD_NORM_TOL for x in run["norm_ratio"].values())):
            failures.append(f"{name}: against the single-GPU step: {run}")
    emit({"phase": "train_wide", "part": "tp", "world": TP_WORLD, "backend": backend,
          "spawn_s": spawn_s, "single_gpu_loss": card_loss, "cpu_loss": want_loss,
          "loss_tol": TRAIN_LOSS_TOL, "cosine_bar": TRAIN_GRAD_COSINE,
          "norm_ratio_tol": TP_GRAD_NORM_TOL, "runs": tp_runs,
          "k11_launches": k11[0], "k11_bwd_launches": k11[1]})
    check(not failures, "train_wide tp: " + "; ".join(failures))

    # the runtime's writer threads may still be finishing a file when the
    # directory goes: a leftover temporary file is no failure of the phase
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_train_",
                                     ignore_cleanup_errors=True) as tmp:
        work = Path(tmp)
        start = write_wide_checkpoints(work / "models", seed + 10, plan["rerank_layers"],
                                       names=("bge-base-ce",), labels=1)["bge-base-ce"]
        ratings = seed_feedback_db(work / "feedback.db")
        reset_launches()
        t0 = time.perf_counter()
        tuned = run_script(train_rerank.main, [
            "--feedback-db", str(work / "feedback.db"), "--model-path", str(start),
            "--out-dir", str(work / "tuned"), "--steps", str(plan["feedback_steps"]),
            "--batch", str(plan["feedback_batch"]), "--seq", str(plan["feedback_seq"]),
            "--device", plan["device"]])
        tune_s = time.perf_counter() - t0
        tune_launches = read_launches()
        check_train_launches(tune_launches, plan["feedback_steps"], plan["rerank_layers"], 1,
                             "feedback fine-tune")
        before, after = (np.load(Path(d) / "model.npz") for d in (start, tuned["checkpoint"]))
        moved = {k: float(np.abs(after[k] - before[k]).max()) for k in before.files}
        check(max(moved.values()) > 0, "feedback fine-tune: the saved weights did not move")

        paths = write_checkpoints(work / "serve_models", seed)
        cfg_rt = FrameworkConfig.from_env()
        cfg_rt.encoders.baai_path = str(paths["bge-small"])
        cfg_rt.encoders.gte_path = str(paths["gte-small"])
        cfg_rt.rerank.model_path = tuned["checkpoint"]
        cfg_rt.llm.gemini_api_key = None
        reset_launches()
        rt = Runtime.build(cfg_rt, data_dir=work / "data", device=plan["device"])
        model = getattr(rt.engine.reranker.model, "inner", rt.engine.reranker.model)
        check(model is not None and model.config.hidden_size == 768
              and model.config.num_heads == 12,
              f"feedback fine-tune: the served reranker is not the tuned 768-wide checkpoint")
        children, ingest_s = ingest_all(rt, write_corpus(work, seed))
        ingest_launches = read_launches()
        query_ms, answers, methods = golden_queries(rt, "tuned bge-base reranker")
        serve_launches = read_launches()
        query_launches = {k: serve_launches[k] - ingest_launches[k] for k in serve_launches}
        check_path_launched(FLAT_PATH, query_launches, "tuned bge-base reranker query path")
        del rt
    emit({"phase": "train_wide", "part": "feedback", "ratings": ratings,
          "tune": {k: v for k, v in tuned.items() if k != "checkpoint"}, "tune_s": tune_s,
          "tune_launches": tune_launches, "max_weight_move": max(moved.values()),
          "served_children": children, "query_p50_ms": statistics.median(query_ms),
          "reranked_methods": methods, "query_launches": query_launches})

    reset_launches()
    t0 = time.perf_counter()
    uplift = run_script(train_uplift.main, [*plan["uplift"], "--device", plan["device"]])
    uplift_launches = read_launches()
    check_path_launched(("packed_topk_fused", *TRAIN_PATH), uplift_launches,
                        "train_uplift --hidden 768")
    emit({"phase": "train_wide", "part": "uplift_768", "argv": plan["uplift"],
          "uplift": uplift["value"], "wall_s": time.perf_counter() - t0,
          "launches": uplift_launches, "phase_s": time.perf_counter() - t_phase})
    return launches["flash_attention_bwd"], k11


# ------------------------------------------------- the multivector tier

MV_TOKENS = 128          # max_child_tokens of the tier (the JAX default)
MV_CAPACITY = 4096
MV_TOL = 1e-3            # card (bf16 storage, bf16 query) against the CPU (f32): scores, ties
MV_COS_MIN = 0.999       # TokenEncoder vectors, card (bf16) against the CPU (f32), per token
MV_PATH = FLAT_PATH      # K1-K4 on the dense leg, K2 and K3 in every token encode
# scripts/bench_multivector.py's configuration: children, tokens, dim, query tokens, k
MV_SCALE = {"device": "cuda", "children": 20480, "tokens": 128, "dim": 384, "qtokens": 16,
            "k": 10, "concepts": 256, "searches": 20}


def maxsim_plain(torch, q, tokens, tok_mask, valid, rows: int = 2048):
    """Every child's MaxSim score in f32 from f32 copies of the stored
    tokens, ``rows`` children at a time: q [Tq, D]; the same masks as the
    index."""
    out = []
    for lo in range(0, tokens.shape[0], rows):
        sims = torch.einsum("qd,ctd->cqt", q.float(), tokens[lo:lo + rows].float())
        sims = sims + (tok_mask[lo:lo + rows, None, :] - 1.0) * 1.0e5
        out.append(sims.amax(dim=2).sum(dim=1) + (valid[lo:lo + rows] - 1.0) * 1.0e5)
    return torch.cat(out)


def same_hits(got, want_scores, ids_of, tol: float = MV_TOL) -> list:
    """got: the card's [{score, child_id}]; want_scores: every slot's score on
    the reference path, ids_of: slot -> child id. Failures: a hit whose
    score is off by more than ``tol``, or a child at a rank where the
    reference puts another one that it does not tie within ``tol``."""
    import numpy as np

    order = np.argsort(-want_scores, kind="stable")[:len(got)]
    by_id = {int(ids_of[s]): float(want_scores[s]) for s in np.flatnonzero(want_scores > -100)}
    fails = []
    for rank, (h, slot) in enumerate(zip(got, order)):
        mine = by_id.get(h["child_id"])
        if mine is None or abs(h["score"] - mine) > tol:
            fails.append(f"rank {rank}: child {h['child_id']} score {h['score']} vs {mine}")
        elif h["child_id"] != int(ids_of[slot]) and abs(mine - want_scores[slot]) > tol:
            fails.append(f"rank {rank}: child {h['child_id']} ({mine}) where the reference "
                         f"has {int(ids_of[slot])} ({want_scores[slot]})")
    return fails


def phase_multivector(torch, work: Path, paths: dict, items, texts):
    """The late-interaction tier at full width: phase 4's bge-small
    checkpoint wrapped in a TokenEncoder on the card (bf16) and a
    MultiVectorIndex(dim 384, 128 tokens, capacity 4,096, bf16: 403 MB of
    tokens) plugged into the hooks of a fresh flat runtime's
    IngestionPipeline and HybridRetriever (Runtime.build wires neither, as
    in the JAX package), with CHILD_USE_MULTIVECTOR=1. Ingest of the 27
    documents (flush waits on the tier's card too), the 9 golden questions.
    Gates: every question answered; the hybrid.multivector span fired once
    a query variant with non-empty lists; K1-K4 launched, and K2 and K3 by
    the token encoder alone (a standalone encode of 16 corpus texts: 12
    launches a forward each); 3 questions' token queries searched on the
    card against MaxSim of the same stored tokens on the CPU in f32, the
    query cast to bf16 as search_aggregate casts it to the storage dtype
    (scores within 1e-3, ids outside ties of 1e-3), and the f32 CPU index
    (f32 query) against its own plain version within 1e-4; the largest
    score difference between the card and that f32 index (the query's bf16
    rounding) is reported; the TokenEncoder's vectors on the card against
    the CPU f32 path at cosine >= 0.999 per token."""
    import numpy as np

    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.index import MultiVectorIndex
    from financial_rag_tpu_torch.models.encoder import Encoder, TokenEncoder
    from financial_rag_tpu_torch.ops import flash_attention as fa
    from financial_rag_tpu_torch.ops import fused_ffn
    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.utils.timing import GLOBAL_TIMER

    os.environ["CHILD_USE_MULTIVECTOR"] = "1"
    try:
        cfg = FrameworkConfig.from_env()
    finally:
        del os.environ["CHILD_USE_MULTIVECTOR"]
    cfg.llm.gemini_api_key = None
    check(cfg.retrieval.multivector_enabled, "CHILD_USE_MULTIVECTOR=1 did not enable the tier")
    rt = Runtime.build(cfg, data_dir=work / "data_multivector", device="cuda")
    enc = rt.dual_encoder.encoders["baai"].inner
    tok = TokenEncoder(enc, max_tokens=MV_TOKENS)
    mv = MultiVectorIndex(dim=enc.dim, max_child_tokens=MV_TOKENS, capacity=MV_CAPACITY,
                          device="cuda")
    check(mv._tokens.dtype == torch.bfloat16 and mv._tokens.is_cuda, "tier storage")
    rt.pipeline.multivector_index, rt.pipeline.token_encoder = mv, tok
    rt.hybrid.multivector_index, rt.hybrid.token_encoder = mv, tok

    lists = []
    search = mv.search_aggregate

    def recording_search(qv, top_k=24):
        hits = search(qv, top_k=top_k)
        lists.append(len(hits))
        return hits

    mv.search_aggregate = recording_search
    reset_launches()
    children, ingest_s = ingest_all(rt, items)
    check(mv.count() == children, f"multivector tier holds {mv.count()} of {children} children")
    spans_before = GLOBAL_TIMER.summary().get("hybrid.multivector", {}).get("count", 0)
    query_ms, answers, methods = golden_queries(rt, "multivector")
    launches = read_launches()
    check_path_launched(MV_PATH, launches, "multivector path")
    spans = GLOBAL_TIMER.summary().get("hybrid.multivector", {})
    fired = spans.get("count", 0) - spans_before
    check(fired >= len(GOLDEN_QUESTIONS) and len(lists) >= len(GOLDEN_QUESTIONS),
          f"multivector: the hybrid.multivector span fired {fired} times, {len(lists)} searches")
    check(all(n > 0 for n in lists), f"multivector: empty MaxSim lists {lists}")
    mv.search_aggregate = search

    # K2 and K3 launched by the token encoder alone
    sample = list(dict.fromkeys(texts))[:16]
    check(len(sample) == 16, "multivector: fewer than 16 distinct corpus texts")
    forwards = []
    hidden = tok._hidden

    def counting_hidden(ids, mask):
        forwards.append(ids.shape)
        return hidden(ids, mask)

    tok._hidden = counting_hidden
    before = (fa.LAUNCHES, fused_ffn.LAUNCHES)
    gpu_vecs = tok.encode_tokens(sample)
    tok_launches = (fa.LAUNCHES - before[0], fused_ffn.LAUNCHES - before[1])
    del tok._hidden
    layers = enc.config.num_layers
    check(tok_launches == (layers * len(forwards),) * 2 and forwards,
          f"token encoder: K2/K3 launches {tok_launches} for {len(forwards)} forwards")

    cpu_enc = Encoder.from_pretrained(str(paths["bge-small"]), pooling="cls", device="cpu",
                                      max_seq_len=enc.max_seq_len)
    cpu_vecs = TokenEncoder(cpu_enc, max_tokens=MV_TOKENS).encode_tokens(sample)
    cos_min = 1.0
    for g, c in zip(gpu_vecs, cpu_vecs):
        check(g.shape == c.shape, f"token vectors {g.shape} vs {c.shape}")
        cos_min = min(cos_min, float(((g * c).sum(1) / (np.linalg.norm(g, axis=1)
                                                         * np.linalg.norm(c, axis=1))).min()))
    check(cos_min >= MV_COS_MIN, f"token encoder: card vs CPU min cosine {cos_min}")

    # the card's MaxSim against the same stored tokens on the CPU in f32
    cpu = MultiVectorIndex(dim=mv.dim, max_child_tokens=MV_TOKENS, capacity=mv.capacity,
                           dtype=torch.float32, device="cpu")
    cpu._tokens, cpu._tok_mask, cpu._valid = (mv._tokens.float().cpu(), mv._tok_mask.cpu(),
                                              mv._valid.cpu())
    cpu._ids, cpu._slot_of, cpu._next_slot = mv._ids.copy(), dict(mv._slot_of), mv._next_slot
    failures, score_err = [], 0.0
    for question in GOLDEN_QUESTIONS[:3]:
        qv = tok.encode_tokens([question])[0]
        got = mv.search_aggregate(qv, top_k=24)
        q = torch.from_numpy(qv / np.linalg.norm(qv, axis=1, keepdims=True))
        # the card's function: the query in the storage dtype, f32 products
        scores = maxsim_plain(torch, q.to(mv.dtype), cpu._tokens, cpu._tok_mask,
                              cpu._valid).numpy()
        failures += [f"{question!r}: {f}" for f in same_hits(got, scores, cpu._ids)]
        # the f32 index on the CPU keeps the query in f32
        want = cpu.search_aggregate(qv, top_k=24)
        scores32 = maxsim_plain(torch, q, cpu._tokens, cpu._tok_mask, cpu._valid).numpy()
        failures += [f"{question!r} (CPU index): {f}"
                     for f in same_hits(want, scores32, cpu._ids, tol=1e-4)]
        score_err = max(score_err, max(abs(g["score"] - w["score"]) for g, w in zip(got, want)))
    check(not failures, "multivector card vs CPU: " + "; ".join(failures[:5]))

    emit({"phase": "multivector", "children": children, "ingest_s": round(ingest_s, 3),
          "children_per_s": round(children / ingest_s, 1),
          "tier_bytes": mv._tokens.numel() * mv._tokens.element_size(),
          "query_p50_ms": round(statistics.median(query_ms), 3),
          "query_max_ms": round(max(query_ms), 3), "reranked_methods": methods,
          "maxsim_searches": len(lists), "maxsim_list_min": min(lists),
          "multivector_span_mean_ms": round(spans.get("mean_s", 0.0) * 1e3, 3),
          "token_encoder_forwards": len(forwards), "token_encoder_k2_k3": list(tok_launches),
          "token_cos_min": cos_min, "card_vs_f32_index_score_max_err": score_err,
          "launches": launches})
    rt.feedback_db.flush_writes()
    return launches


def fill_multivector(torch, idx, n: int, concepts: int, gen):
    """scripts/bench_multivector.py's corpus, made on the device: child c's
    tokens are its concept's anchors plus normal(0.35) noise, unit rows,
    every token slot live. Returns the concepts [n] (CPU)."""
    import numpy as np

    t, d, dev = idx.max_child_tokens, idx.dim, idx.device
    anchors = torch.randn(concepts, t, d, generator=gen, device=dev)
    concept_of = torch.randint(0, concepts, (n,), generator=gen, device=dev)
    for lo in range(0, n, 1024):
        c = concept_of[lo:lo + 1024]
        toks = anchors[c] + 0.35 * torch.randn(len(c), t, d, generator=gen, device=dev)
        idx._tokens[lo:lo + len(c)] = (toks / toks.norm(dim=-1, keepdim=True)).to(idx.dtype)
    idx._tok_mask[:n] = 1.0
    idx._valid[:n] = 1.0
    idx._ids[:n] = np.arange(1, n + 1)
    idx._slot_of = {i + 1: i for i in range(n)}
    idx._next_slot = n
    return concept_of.cpu()


def phase_multivector_scale(torch, seed: int, plan=MV_SCALE):
    """MaxSim at scripts/bench_multivector.py's configuration: 20,480
    children x 128 tokens x 384 bf16 (2.01 GB) synthesised on the device,
    16-token queries (a child's tokens plus noise), k 10. CUDA events
    around each search_aggregate call (host normalisation, the sweep, the
    sort and the copy back), median and IQR over 20 queries after 2
    warm-up searches; the sweep alone (scores and sort) by cuda_ms; the
    search's peak memory above what the index holds; the bound: the
    token block, masks and valid vector read once at 3.35 TB/s against the
    2 x children x tokens x Tq x D products at the bf16 peak. One query's
    top 10 against a plain chunked f32 recomputation (ties of 1e-3)."""
    import numpy as np

    from financial_rag_tpu_torch.index import MultiVectorIndex
    from financial_rag_tpu_torch.index.multivector import maxsim_scores

    n, t, d, tq, k = (plan[x] for x in ("children", "tokens", "dim", "qtokens", "k"))
    torch.cuda.empty_cache()
    idx = MultiVectorIndex(dim=d, max_child_tokens=t, capacity=n, device=plan["device"])
    gen = torch.Generator(device=idx.device)
    gen.manual_seed(seed + 17)
    concept_of = fill_multivector(torch, idx, n, plan["concepts"], gen)
    rng = np.random.default_rng(seed)
    targets = rng.choice(n, size=plan["searches"] + 2, replace=False)
    queries = []
    for c in targets:
        sel = torch.from_numpy(rng.choice(t, size=tq, replace=False)).to(idx.device)
        qv = idx._tokens[int(c)][sel].float().cpu().numpy()
        qv = qv + 0.25 * rng.standard_normal(qv.shape).astype(np.float32)
        queries.append(qv)
    for qv in queries[:2]:
        idx.search_aggregate(qv, top_k=k)
    torch.cuda.synchronize()
    ms, hits_at_1 = [], 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for c, qv in zip(targets[2:], queries[2:]):
        start.record()
        hits = idx.search_aggregate(qv, top_k=k)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        hits_at_1 += hits[0]["child_id"] == int(c) + 1
    q25, med, q75 = np.percentile(ms, [25, 50, 75])

    qv = queries[2] / np.linalg.norm(queries[2], axis=1, keepdims=True)
    q = torch.from_numpy(qv).to(idx.device, idx.dtype)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = idx.search_aggregate(queries[2], top_k=k)
    torch.cuda.synchronize()
    peak_extra = torch.cuda.max_memory_allocated() - base
    rows = idx._sweep_rows(tq)
    check(peak_extra <= 2 * rows * tq * t * 4 + (64 << 20),
          f"multivector search peak {peak_extra} bytes above the index")

    def sweep():
        s = torch.cat([maxsim_scores(q, idx._tokens[lo:lo + rows], idx._tok_mask[lo:lo + rows],
                                     idx._valid[lo:lo + rows])
                       for lo in range(0, idx.capacity, rows)])
        return torch.sort(s, descending=True, stable=True)

    sweep_ms = cuda_ms(torch, sweep)
    want = maxsim_plain(torch, q, idx._tokens, idx._tok_mask, idx._valid).cpu().numpy()
    fails = same_hits(got, want, idx._ids)
    check(not fails, "multivector scale vs the f32 recomputation: " + "; ".join(fails[:5]))
    block = idx._tokens.numel() * idx._tokens.element_size()
    bound_ms, bound_by = bound(block + idx._tok_mask.numel() * 4 + idx._valid.numel() * 4,
                               2 * n * t * tq * d, "bf16")
    emit({"phase": "multivector_scale", "children": n, "tokens": t, "dim": d, "qtokens": tq,
          "k": k, "token_bytes": block, "sweep_rows": rows,
          "search_ms_median": float(med), "search_ms_iqr": [float(q25), float(q75)],
          "searches": len(ms), "sweep_ms": sweep_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "peak_extra_bytes": int(peak_extra), "hit_at_1": hits_at_1 / len(ms),
          "concepts": int(concept_of.unique().numel())})
    del idx
    torch.cuda.empty_cache()


# ------------------------------------------- tensor-parallel decoding

# Card, tp 2, against the single-device port on the card: in bf16 the
# last-position prefill logits and every decode step's logits (both paths
# fed the single-device tokens) by cosine per row; in f32 the greedy tokens,
# up to the first step whose single-device top-2 margin is below
# DECODER_TP_TIE x max |logit|. bf16 tokens are reported, not gated: the
# ranks' f32 partial sums round at other points than one device's GEMMs,
# and 24 random layers carry that past a margin of 1e-3 (PERF.md §6).
DECODER_TP_COSINE = 0.995
DECODER_TP_TIE = 1e-3
DECODER_TP_PLAN = {"device": "cuda", "hf": QWEN2_05B, "tp": 2, "lengths": (512, 384, 200, 77),
                   "new_tokens": 16, "repeats": 3}
DECODER_TP_TIMEOUT_S = 300


def seeded_decoder_params(torch, cfg, seed: int, device):
    """Random bf16 decoder params made on ``device`` from ``seed``, in the
    port's layout ([in, out] matrices; normal(0.02) matrices and biases, unit
    norms): the same numbers in every process that asks on one device type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, kv, ff = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim, cfg.intermediate_size

    def normal(*shape):
        return (torch.randn(*shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    params = {"embed": normal(cfg.vocab_size, h), "final_ln": ones(h), "layers": []}
    for _ in range(cfg.num_layers):
        lp = {"ln1": ones(h), "q_w": normal(h, h), "k_w": normal(h, kv), "v_w": normal(h, kv),
              "o_w": normal(h, h), "ln2": ones(h), "gate_w": normal(h, ff),
              "up_w": normal(h, ff), "down_w": normal(ff, h)}
        if cfg.attention_bias:
            lp.update(q_b=normal(h), k_b=normal(kv), v_b=normal(kv))
        params["layers"].append(lp)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.vocab_size, h)
    return params


def as_f32(params):
    """The same params in f32 (a shard's DecoderShard kept)."""
    return {k: ([{n: t.float() for n, t in lp.items()} for lp in v] if k == "layers"
                else v.float() if hasattr(v, "float") else v)
            for k, v in params.items()}


def decoder_tp_prompts(cfg, plan, seed: int):
    """Left-padded prompts of plan's lengths: (ids, mask) int32 numpy."""
    import numpy as np

    lengths = plan["lengths"]
    s = max(lengths)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (len(lengths), s)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, n in enumerate(lengths):
        ids[row, :s - n] = 0
        mask[row, :s - n] = 0
    return ids, mask


def forced_logits(torch, params, ids, mask, cfg, forced):
    """f32 logits [steps, B, V] (CPU) of every generation step with the
    tokens ``forced`` [B, steps] fed in turn: step 0 is the prefill's last
    position, step g the decode step that feeds forced[:, g - 1], as
    generate_tokens feeds its own tokens."""
    from financial_rag_tpu_torch.models import decoder

    b, s = ids.shape
    steps = forced.shape[1]
    forced = torch.as_tensor(forced).to(ids.device)
    with torch.inference_mode():
        last, kc, vc = decoder._prefill(params, ids, mask, s + steps, cfg)
        pm = torch.cat([mask == 1, torch.ones((b, steps), dtype=torch.bool, device=ids.device)],
                       dim=1)
        pos0 = mask.sum(dim=1)
        out = [last.float().cpu()]
        for g in range(steps - 1):
            out.append(decoder._decode_one(params, forced[:, g], pos0 + g, s + g, kc, vc, pm,
                                           cfg).float().cpu())
    return torch.stack(out)


def decoder_tp_rank(rank, world, device, seed, plan, forced):
    """One rank of phase_decoder_tp: this rank's shard of the seeded decoder.
    bf16: the prefill (K9's launches and head counts, the all-reduces),
    generate_tokens (the all-reduces), each timed on the host clock around
    work that ends in a synchronise (median of plan["repeats"]), and every
    step's logits fed the single-device tokens ``forced["bf16"]`` (rank 0
    returns them); f32 (the same weights): generate_tokens."""
    import hashlib

    import torch

    from financial_rag_tpu_torch.models import decoder
    from financial_rag_tpu_torch.ops import causal_flash
    from financial_rag_tpu_torch.parallel import comm, train_mesh

    cfg = decoder.DecoderConfig.from_hf_config(plan["hf"])
    mesh = train_mesh(plan["tp"], timeout_s=DECODER_TP_TIMEOUT_S)
    full = seeded_decoder_params(torch, cfg, seed, device)
    embed_sha = hashlib.sha256(full["embed"][:64].float().cpu().numpy().tobytes()).hexdigest()
    params = decoder.shard_decoder_params(full, mesh, cfg)
    del full
    ids, mask = (torch.from_numpy(a).to(device) for a in decoder_tp_prompts(cfg, plan, seed))
    new = plan["new_tokens"]
    heads, reduces = [], [0]
    k9, all_reduce = decoder.causal_flash_prefill, comm.all_reduce_

    def recording_k9(q, k, v, pad_len, *, num_q_heads, num_kv_heads):
        heads.append((num_q_heads, num_kv_heads))
        return k9(q, k, v, pad_len, num_q_heads=num_q_heads, num_kv_heads=num_kv_heads)

    def counting_all_reduce(t, mesh, axis, op="sum"):
        reduces[0] += 1
        return all_reduce(t, mesh, axis, op)

    decoder.causal_flash_prefill, comm.all_reduce_ = recording_k9, counting_all_reduce
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    k9_start = causal_flash.LAUNCHES
    try:
        prefill_ms, gen_ms = [], []
        for _ in range(plan["repeats"]):
            sync()
            k9_before, reduces[0] = causal_flash.LAUNCHES, 0
            t0 = time.perf_counter()
            with torch.inference_mode():
                decoder._prefill(params, ids, mask, ids.shape[1] + new, cfg)
            sync()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        k9_per_prefill, reduces_prefill = causal_flash.LAUNCHES - k9_before, reduces[0]
        for _ in range(plan["repeats"]):
            sync()
            reduces[0] = 0
            t0 = time.perf_counter()
            toks = decoder.generate_tokens(params, ids, mask, cfg=cfg, max_new_tokens=new)
            sync()
            gen_ms.append((time.perf_counter() - t0) * 1e3)
        reduces_generate = reduces[0]
        logits = forced_logits(torch, params, ids, mask, cfg, forced["bf16"])
        toks32 = decoder.generate_tokens(as_f32(params), ids, mask, cfg=cfg, max_new_tokens=new)
        k9_total = causal_flash.LAUNCHES - k9_start
    finally:
        decoder.causal_flash_prefill, comm.all_reduce_ = k9, all_reduce
    return {"rank": rank, "coords": dict(mesh.coords), "device": str(device),
            "embed_sha": embed_sha, "tokens": toks.cpu().numpy(),
            "tokens_f32": toks32.cpu().numpy(), "logits": logits if rank == 0 else None,
            "k9_launches_per_prefill": k9_per_prefill, "k9_launches": k9_total,
            "k9_heads": sorted(set(heads)),
            "prefill_ms": statistics.median(prefill_ms), "generate_ms": statistics.median(gen_ms),
            "all_reduces_prefill": reduces_prefill, "all_reduces_generate": reduces_generate,
            "local_layer": {k: list(v.shape) for k, v in params["layers"][0].items()}}


def first_ties(torch, logits, tie: float) -> list:
    """Per row, the first step whose top-2 margin is below ``tie`` x max
    |logit| (None: no such step); logits [steps, B, V]."""
    top2 = logits.topk(2, dim=-1).values
    rel = ((top2[..., 0] - top2[..., 1]) / logits.abs().amax(dim=-1)).numpy()
    return [next((i for i in range(rel.shape[0]) if rel[i, r] < tie), None)
            for r in range(rel.shape[1])]


def first_difference(got, want) -> list:
    """Per row, the first step where the tokens differ (their count: none)."""
    import numpy as np

    return [int(np.argmax(np.append(g != w, True))) for g, w in zip(got, want)]


def phase_decoder_tp(torch, seed: int, info: dict, plan=DECODER_TP_PLAN):
    """Tensor-parallel decoding at the local LLM cell's Qwen2-0.5B shape (24
    layers, hidden 896, 14 / 2 heads of 64, FFN 4,864, vocab 151,936, tied
    embeddings): tp 2 (the most that 2 kv heads allow) on 2 ranks started
    by parallel.launch.spawn, sharing the one card over gloo; batch 4 of
    left-padded prompts up to 512 tokens, 16 new greedy tokens. Gates, against
    the single-device port on the card on the same weights: the ranks'
    tokens identical (bf16 and f32); in bf16 the per-row cosine of the
    prefill's last-position logits and of every decode step's logits (both
    fed the single-device tokens) >= 0.995; in f32 the greedy tokens equal
    up to the first step whose single-device top-2 margin is below 1e-3 x
    max |logit|; K9 launched num_layers times a prefill on each rank, at 7
    query / 1 kv heads; 2 all-reduces a layer in the prefill. The bf16
    tokens' first difference from one device is reported with the margin
    and the logits' deviation there. Then dryrun_multichip's section 5 (dp 2
    x tp 2, 4 ranks on the card) against the single-rank port. Returns K9's
    launches on the ranks."""
    import hashlib

    from financial_rag_tpu_torch.models import decoder
    from financial_rag_tpu_torch.parallel import launch
    from financial_rag_tpu_torch.scripts import dryrun_multichip

    cfg = decoder.DecoderConfig.from_hf_config(plan["hf"])
    tp, new = plan["tp"], plan["new_tokens"]
    sync = torch.cuda.synchronize if plan["device"] == "cuda" else (lambda: None)

    # the single-device port on the same weights and prompts
    params = seeded_decoder_params(torch, cfg, seed, plan["device"])
    embed_sha = hashlib.sha256(params["embed"][:64].float().cpu().numpy().tobytes()).hexdigest()
    ids, mask = (torch.from_numpy(a).to(plan["device"])
                 for a in decoder_tp_prompts(cfg, plan, seed))
    single, single_ms = {}, {}
    for name, p in (("bf16", params), ("f32", as_f32(params))):
        sync()
        t0 = time.perf_counter()
        toks = decoder.generate_tokens(p, ids, mask, cfg=cfg, max_new_tokens=new)
        sync()
        single_ms[name] = (time.perf_counter() - t0) * 1e3
        single[name] = toks.cpu().numpy()
        if name == "bf16":
            want_logits = forced_logits(torch, p, ids, mask, cfg, toks)
        else:
            ties32 = first_ties(torch, forced_logits(torch, p, ids, mask, cfg, toks),
                                DECODER_TP_TIE)
    del params, p
    if plan["device"] == "cuda":
        torch.cuda.empty_cache()

    backend, _ = launch.choose_backend(tp, plan["device"])
    t0 = time.perf_counter()
    ranks = launch.spawn(decoder_tp_rank, tp, args=(seed, plan, single), device=plan["device"],
                         timeout_s=DECODER_TP_TIMEOUT_S, join_timeout_s=600)
    spawn_s = time.perf_counter() - t0

    failures = []
    for r in ranks:
        if r["embed_sha"] != embed_sha:
            failures.append(f"rank {r['rank']}: its seeded weights differ from the parent's")
        for key in ("tokens", "tokens_f32"):
            if not (r[key] == ranks[0][key]).all():
                failures.append(f"rank {r['rank']}: {key} differ from rank 0's")
        if r["k9_launches_per_prefill"] != cfg.num_layers:
            failures.append(f"rank {r['rank']}: K9 {r['k9_launches_per_prefill']} a prefill")
        if r["k9_heads"] != [(cfg.num_heads // tp, cfg.num_kv_heads // tp)]:
            failures.append(f"rank {r['rank']}: K9 heads {r['k9_heads']}")
        if r["all_reduces_prefill"] != 2 * cfg.num_layers:
            failures.append(f"rank {r['rank']}: {r['all_reduces_prefill']} all-reduces a prefill")
    got = ranks[0]["logits"]
    steps = min(got.shape[0], want_logits.shape[0])
    cos = torch.nn.functional.cosine_similarity(got[:steps], want_logits[:steps], dim=-1)
    if cos.min() < DECODER_TP_COSINE:
        failures.append(f"logits cosine by step and row {cos.tolist()}")
    agree32 = first_difference(ranks[0]["tokens_f32"], single["f32"])
    for row, (tie, at) in enumerate(zip(ties32, agree32)):
        if at < (new if tie is None else tie):
            failures.append(f"f32 row {row}: tokens differ at step {at}, before the first near "
                            f"tie ({tie})")
    # where the bf16 tokens first differ: the single-device margin and the
    # two paths' largest logit difference there, each over max |logit|
    agree = first_difference(ranks[0]["tokens"], single["bf16"])
    at_difference = []
    for row, at in enumerate(agree):
        if at < steps:
            w, g = want_logits[at, row], got[at, row]
            top2 = w.topk(2).values
            scale = float(w.abs().max())
            at_difference.append({"row": row, "step": at,
                                  "margin": float(top2[0] - top2[1]) / scale,
                                  "max_abs_diff": float((g - w).abs().max()) / scale})
    check(not failures, "decoder_tp: " + "; ".join(failures))

    t1 = time.perf_counter()
    section5 = dryrun_multichip.decoder_tp(4, torch.device(plan["device"]))
    section5_s = time.perf_counter() - t1
    emit({"phase": "decoder_tp", "ranks": tp, "backend": backend, "card": info["nvidia_smi"],
          "layers": cfg.num_layers, "local_heads": [cfg.num_heads // tp, cfg.num_kv_heads // tp],
          "local_layer_shapes": ranks[0]["local_layer"],
          "batch": len(plan["lengths"]), "prompt_lengths": list(plan["lengths"]),
          "new_tokens": new, "spawn_s": round(spawn_s, 3),
          "prefill_ms": [r["prefill_ms"] for r in ranks],
          "decode_step_ms": [(r["generate_ms"] - r["prefill_ms"]) / (new - 1) for r in ranks],
          "generate_ms": [r["generate_ms"] for r in ranks],
          "all_reduces_per_step": (ranks[0]["all_reduces_generate"]
                                   - ranks[0]["all_reduces_prefill"]) / (new - 1),
          "single_device_generate_ms": single_ms,
          "prefill_logits_cosine": cos[0].tolist(), "step_logits_cosine_min": float(cos.min()),
          "f32_near_tie_step_by_row": ties32, "f32_tokens_agree_through_by_row": agree32,
          "bf16_tokens_agree_through_by_row": agree, "bf16_first_difference": at_difference,
          "k9_launches_per_prefill": [r["k9_launches_per_prefill"] for r in ranks],
          "k9_launches": [r["k9_launches"] for r in ranks],
          "dryrun_section5": {**section5, "seconds": round(section5_s, 3)}})
    return sum(r["k9_launches"] for r in ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None,
                    help="also write the kernel build log and the kernels line here")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
            work = Path(tmp)
            rt, cfg, paths, items, launches, texts, served = phase_slice(torch, args.seed, work)
            phase_profile(torch, rt)
            rt_ivf, ivf_launches = phase_ivf(torch, cfg, work, items)
            phase_profile(torch, rt_ivf, label="ivf")
            del rt_ivf
            int8_launches = phase_int8(torch, rt, cfg, work)
            sharded_launches, sharded_ivf_launches = phase_sharded(torch, cfg, work, items, rt,
                                                                   served, texts)
            phase_sharded_scale(torch, args.seed)
            phase_serve(torch, cfg, work, served, info)
            phase_load(torch, cfg, work, info, args.seed)
            backend_launches = phase_backends(torch, rt, cfg, work)
            phase_parity(torch, rt, paths, texts)
            phase_wide(torch, cfg, work, items, args.seed)
            mv_launches = phase_multivector(torch, work, paths, items, texts)
            phase_multivector_scale(torch, args.seed)
            rt_llm, ckpt, llm_launches = phase_llm(torch, cfg, work, args.seed)
            phase_llm_profile(torch, rt_llm)
            phase_decoder_parity(torch, rt_llm, ckpt)
            del rt, rt_llm
            torch.cuda.empty_cache()
            k9_d128 = phase_llm_d128(torch, cfg, work, args.seed)["causal_flash_prefill"]
            k9_tp = phase_decoder_tp(torch, args.seed, info)
            # each kernel's count from the path that serves it
            launches["causal_flash_prefill"] = llm_launches["causal_flash_prefill"]
            launches["bucketed_topk_fused"] = int8_launches["bucketed_topk_fused"]
            launches["topk_matmul"] = backend_launches["topk_matmul"]
            launches["bucketed_topk"] = sharded_launches["bucketed_topk"]
            launches["probe_scores"] = ivf_launches["probe_scores"]
            train_launches = phase_train(torch, args.seed)
            want_loss, want, _, _ = phase_train_parity(torch, args.seed)
            launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
            launches["flash_attention_tp"], tp_bwd = phase_train_tp(torch, args.seed, info,
                                                                     want_loss, want)
            k10_d64, (k11_d64, k11_bwd_d64) = phase_train_wide(torch, args.seed, info)
            launches["flash_attention_tp"] += k11_d64
            tp_bwd += k11_bwd_d64
            phase_cli(torch, work, args.seed)     # phase 4's checkpoints and corpus
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
        if name == "flash_attention_tp":   # its forward launches above; K10 at local heads
            kernels[-1]["bwd_launches"] = tp_bwd
            kernels[-1]["launches_d64"], kernels[-1]["bwd_launches_d64"] = k11_d64, k11_bwd_d64
        if name == "flash_attention_bwd":
            kernels[-1]["launches_d64"] = k10_d64
        if name == "causal_flash_prefill":  # K9 on each rank's 7 / 1 local heads; at 128
            kernels[-1]["launches_tp"], kernels[-1]["launches_d128"] = k9_tp, k9_d128
        if name in ("flash_attention", "fused_ffn"):   # the multivector path's
            kernels[-1]["launches_multivector"] = mv_launches[name]
        for d in (64, 128):                # the same kernel at heads of 64 or 128
            if f"{name}@{d}" in timings:
                kernels[-1][f"d{d}"] = {k: timings[f"{name}@{d}"][k] for k in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms") if k in timings[f"{name}@{d}"]}
        if "ffn_three_call_ms" in t:       # three calls, so not K3's library_ms
            kernels[-1]["ffn_three_call_ms"] = t["ffn_three_call_ms"]
        if "topk_two_call_ms" in t:        # two calls, so not K4's library_ms
            kernels[-1]["topk_two_call_ms"] = t["topk_two_call_ms"]
        if "sweep_kernels" in t:           # the profiler's name of the sweep that ran
            kernels[-1]["sweep_kernels"] = t["sweep_kernels"]
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1)})
    line = {"kernels": kernels}
    if log_dir:
        (Path(log_dir) / "kernels.json").write_text(json.dumps(line, indent=1))
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
