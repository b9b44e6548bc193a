"""Print per-model collection counts and the parent and child counts.

    python -m financial_rag_tpu_torch.scripts.check_collections [--data-dir .]

The port's counterpart of the root ``scripts/check_collections.py``: the
same flag and lines, on the GPU (``FRAG_PLATFORM=cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=".")
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.runtime import Runtime

    rt = Runtime.build(data_dir=args.data_dir)
    for name, idx in rt.indexes.items():
        print(f"{idx.name}: {idx.count()} vectors (capacity {idx.capacity}, "
              f"backend {idx.backend})")
    print(f"parents.db: {rt.parent_store.count()} parents")
    print(f"children_meta.db: {rt.child_meta.count()} children")
    return 0


if __name__ == "__main__":
    sys.exit(main())
