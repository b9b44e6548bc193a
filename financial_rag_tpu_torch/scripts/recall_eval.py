"""recall@10 of the dual-ensemble + RRF retrieval pipeline against an f32
exact-search oracle on the host.

    python -m financial_rag_tpu_torch.scripts.recall_eval [--n-synth 2000] [--k 10]
        [--fetch-k 24] [--out RECALL.json]

The port's counterpart of the root ``scripts/recall_eval.py``: the same
flags, JSON keys and method, with ``backend`` the device the indexes ran
on (``cuda``, or ``cpu`` under ``FRAG_PLATFORM=cpu``). Embeddings are held
fixed (the deterministic lexical encoders, or real checkpoints through
EMBED_*_PATH), so the number isolates what the framework owns: the bf16
index (K4's flat sweep on the GPU), the per-model search, RRF fusion and
its tie order. The oracle runs the same two embedding matrices through
numpy f32 exact search and the same RRF.

Corpus: synthetic financial chunks (the root script also adds the
children of a reference extraction JSON when its file exists on the
machine; this one reads only what it generates). Queries: the reference's
golden questions and paraphrases. Writes ``--out`` and prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

GOLDEN = [
    "What is the rent for the first year?",
    "What is the rent for the second year?",
    "What is the lock-in period?",
    "Who is the lessor?",
    "What is the total invoice amount?",
    "What is the GST amount?",
    "credit note number and date",
    "what amount was credited on the tax invoice",
    "monthly rent amount agreed in the lease",
    "supplier name on the invoice",
    "security deposit for the warehouse",
    "eighteen percent tax on the bill",
]

TOPICS = [
    ("lease", "The lease agreement specifies a monthly rent of Rs {a},{b}00 for "
     "year {y}. The lock-in period is {m} months and the lessor is {name}."),
    ("invoice", "Tax Invoice number INV-{a} dated {d} March: total amount "
     "Rs {a},{b}18 with GST at 18 percent amounting to Rs {b},0{y}4."),
    ("credit", "Credit Note CN-{a} issued against invoice {b}: credited amount "
     "Rs {y}9,{a}00 towards returned goods from {name}."),
    ("deposit", "Security deposit of Rs {a},{b}0,000 paid for the warehouse at "
     "{name} industrial area, refundable after {m} months."),
    ("misc", "Board meeting minutes {a}: approved capital expenditure of "
     "Rs {b} lakh for the {name} project in quarter {y}."),
]

NAMES = ["Bhartiya Enterprises", "Chakulia Traders", "Singhbhum Logistics",
         "Amber Warehousing", "Eastern Supplies"]


def synth_corpus(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n):
        _, tpl = TOPICS[i % len(TOPICS)]
        texts.append(tpl.format(
            a=int(rng.integers(10, 99)), b=int(rng.integers(10, 99)),
            y=int(rng.integers(1, 9)), m=int(rng.integers(12, 60)),
            d=int(rng.integers(1, 28)), name=NAMES[int(rng.integers(len(NAMES)))]))
    return texts


def rrf_fuse(rank_lists, k_rrf=60):
    """rank_lists: list of [Q, K] int id arrays (per model). Returns per-query
    fused top ids (all candidates, RRF-scored, stable ties)."""
    nq = rank_lists[0].shape[0]
    fused = []
    for qi in range(nq):
        scores = {}
        for ranks in rank_lists:
            for r, cid in enumerate(ranks[qi]):
                scores[int(cid)] = scores.get(int(cid), 0.0) + 1.0 / (k_rrf + r + 1)
        order = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        fused.append([cid for cid, _ in order])
    return fused


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-synth", type=int, default=2000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--fetch-k", type=int, default=24)  # reference candidate count
    ap.add_argument("--out", default="RECALL.json")
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.config import FrameworkConfig
    from financial_rag_tpu_torch.device import resolve_device
    from financial_rag_tpu_torch.index.flat import FlatIndex
    from financial_rag_tpu_torch.runtime import _build_encoder

    device = resolve_device()     # the GPU unless FRAG_PLATFORM=cpu
    cfg = FrameworkConfig.from_env()
    encoders = {
        "baai": _build_encoder("baai", cfg.encoders.baai_path, "cls", cfg, device),
        "gte": _build_encoder("gte", cfg.encoders.gte_path, "mean", cfg, device),
    }
    real_weights = all(type(e).__name__ == "Encoder" for e in encoders.values())

    texts = synth_corpus(args.n_synth)
    n = len(texts)
    ids = np.arange(1, n + 1, dtype=np.int64)

    emb = {name: enc.encode(texts) for name, enc in encoders.items()}
    q_emb = {name: enc.encode(GOLDEN) for name, enc in encoders.items()}

    # ours: bf16 device indexes + the flat sweep + RRF
    ours_ranks = []
    for name in encoders:
        idx = FlatIndex(dim=emb[name].shape[1], capacity=max(n, 1024), name=name,
                        device=device)
        idx.upsert(ids, emb[name])
        got_ids, _ = idx.search(q_emb[name], args.fetch_k)
        ours_ranks.append(got_ids)
    ours = [r[: args.k] for r in rrf_fuse(ours_ranks)]

    # oracle: f32 exact numpy + identical RRF
    oracle_ranks = []
    for name in encoders:
        s = q_emb[name].astype(np.float32) @ emb[name].astype(np.float32).T
        order = np.argsort(-s, axis=1, kind="stable")[:, : args.fetch_k]
        oracle_ranks.append(ids[order])
    oracle = [r[: args.k] for r in rrf_fuse(oracle_ranks)]

    recalls = [len(set(a) & set(b)) / args.k for a, b in zip(ours, oracle)]
    recall = float(np.mean(recalls))
    result = {
        "metric": f"pipeline recall@{args.k} vs f32 exact oracle (dual-ensemble + RRF)",
        "value": round(recall, 4),
        "unit": "recall",
        "vs_baseline": round(recall / 1.0, 4),  # north star: parity = 1.0
        "n_chunks": n,
        "n_queries": len(GOLDEN),
        "fetch_k": args.fetch_k,
        "encoders": "real checkpoints" if real_weights else
                    "deterministic lexical fallback (no real weights obtainable; see RECALL.md)",
        "per_query": [round(r, 3) for r in recalls],
        "backend": str(device),
    }
    Path(args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
