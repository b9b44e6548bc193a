"""End-to-end runner: extract -> ingest -> report counts -> retrieval smoke.

    python -m financial_rag_tpu_torch.scripts.run_end_to_end --input DIR [--data-dir .]
        [--extracted-dir extracted] [--smoke-query "..."] [--skip-smoke]

The port's counterpart of the root ``scripts/run_end_to_end.py``: the same
flags and lines, on the GPU (``FRAG_PLATFORM=cpu`` for the CPU). JSON
inputs pass through; PDFs need the ``marker`` tool.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="source documents dir (pdf/json)")
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--extracted-dir", default="extracted")
    ap.add_argument("--smoke-query", default="What is the total invoice amount?")
    ap.add_argument("--skip-smoke", action="store_true")
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.ingest.extraction import marker_available, run_marker
    from financial_rag_tpu_torch.runtime import Runtime

    rt = Runtime.build(data_dir=args.data_dir)

    # 1) extraction
    input_dir = Path(args.input)
    extracted_dir = Path(args.extracted_dir)
    marker = marker_available() or "not installed — JSON passthrough only"
    print(f"[1/3] extraction (marker: {marker})")
    json_paths = []
    for p in sorted(input_dir.rglob("*")):
        if p.is_file() and not p.name.endswith("_meta.json"):
            try:
                json_paths.append((p, run_marker(p, extracted_dir / p.stem)))
            except RuntimeError as e:
                print(f"  skip {p.name}: {e}")

    # 2) ingestion
    print(f"[2/3] ingesting {len(json_paths)} documents")
    for src, jp in json_paths:
        stats = rt.pipeline.ingest_extracted_json(
            jp, src.stem, source_path=str(src), source_mtime=src.stat().st_mtime)
        print(f"  {src.stem}: {stats.get('parents', 0)} parents, "
              f"{stats.get('children', 0)} children")
    for name, idx in rt.indexes.items():
        print(f"  collection {idx.name}: {idx.count()} vectors")
    rt.save_indexes(args.data_dir)

    # 3) retrieval smoke
    if not args.skip_smoke:
        print(f"[3/3] retrieval smoke: {args.smoke_query!r}")
        out = rt.dense_retriever.query(args.smoke_query, top_k=8, dedup_parents=3)
        for hit in out["child_hits"][:5]:
            print(f"  child {hit['child_id']} (rrf {hit['rrf_score']:.4f}): "
                  f"{hit['snippet'][:100]!r}")
        for p in out["parent_contexts"]:
            print(f"  parent {p['parent_id']} doc={p['document_id']} "
                  f"pages={p['page_start']}-{p['page_end']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
