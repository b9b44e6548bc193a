"""Dense-retrieval smoke check: embeds a few queries through the dense
parent-context path and prints the top children and parents.

    python -m financial_rag_tpu_torch.scripts.pc_retrieval_smoke [--data-dir .]
        [--queries q1 q2 ...] [--top-k 8]

The port's counterpart of the root ``scripts/pc_retrieval_smoke.py``: the
same flags and lines, on the GPU (``FRAG_PLATFORM=cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import sys

DEFAULT_QUERIES = [
    "What is the total invoice amount?",
    "What is the GST amount?",
    "credit note number and date",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--queries", nargs="*", default=DEFAULT_QUERIES)
    ap.add_argument("--top-k", type=int, default=8)
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.runtime import Runtime

    rt = Runtime.build(data_dir=args.data_dir)
    counts = {n: i.count() for n, i in rt.indexes.items()}
    print(f"collections: {counts}")
    if not any(counts.values()):
        print("indexes are empty — run financial_rag_tpu_torch.scripts.ingest_all first")
        return 0

    for q in args.queries:
        out = rt.dense_retriever.query(q, top_k=args.top_k, dedup_parents=4)
        print(f"\nQ: {q}")
        for hit in out["child_hits"][:5]:
            print(f"  child {hit['child_id']} rrf={hit['rrf_score']:.4f} "
                  f"{(hit['snippet'] or '')[:90]!r}")
        for p in out["parent_contexts"]:
            print(f"  parent {p['parent_id']} doc={p['document_id']} "
                  f"pages {p['page_start']}-{p['page_end']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
