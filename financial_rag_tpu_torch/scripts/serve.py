"""Start the search API server: an optional auto-ingest daemon and the
threaded HTTP server, on the GPU (``FRAG_PLATFORM=cpu`` for the CPU).

    python -m financial_rag_tpu_torch.scripts.serve [--data-dir DIR] [--host H]
        [--port 5000] [--auto-ingest]

The port's counterpart of the root ``scripts/serve.py``, and what
``python -m financial_rag_tpu_torch`` runs.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--auto-ingest", action="store_true")
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.serving.app import run_server

    rt = Runtime.build(data_dir=args.data_dir)
    processor = rt.make_processor(args.data_dir)
    if args.auto_ingest or rt.config.ingest.auto_ingest:
        processor.start()
    app = rt.make_app(processor=processor, data_dir=args.data_dir)
    host = args.host or rt.config.serving.host
    port = args.port or rt.config.serving.port
    print(f"serving on http://{host}:{port} "
          f"(indexes: { {n: i.count() for n, i in rt.indexes.items()} })", flush=True)
    run_server(app, host=host, port=port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
