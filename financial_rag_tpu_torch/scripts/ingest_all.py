"""Ingest a directory of extraction JSONs and print per-collection counts.

    python -m financial_rag_tpu_torch.scripts.ingest_all [--dir "New folder"] [--data-dir .]

The port's counterpart of the root ``scripts/ingest_all.py``: the same
flags and lines, on the GPU (``FRAG_PLATFORM=cpu`` for the CPU). The
indexes are saved under ``--data-dir`` for the other scripts to reload.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="New folder")
    ap.add_argument("--data-dir", default=".")
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.runtime import Runtime

    rt = Runtime.build(data_dir=args.data_dir)
    results = rt.pipeline.ingest_directory(args.dir)
    ok = [r for r in results if "error" not in r]
    bad = [r for r in results if "error" in r]
    print(f"ingested {len(ok)} documents ({len(bad)} failed)")
    for r in bad:
        print(f"  FAILED {r['document_id']}: {r['error']}")
    for name, idx in rt.indexes.items():
        print(f"collection {idx.name}: {idx.count()} vectors")
    print(f"parents.db: {rt.parent_store.count()} parents")
    rt.save_indexes(args.data_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
