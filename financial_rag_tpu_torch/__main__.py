"""`python -m financial_rag_tpu_torch` starts the search API server on the GPU
(``FRAG_PLATFORM=cpu`` serves from the CPU)."""

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(prog="financial_rag_tpu_torch",
                                 description="PyTorch/CUDA retrieval framework server")
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--auto-ingest", action="store_true")
    args = ap.parse_args()

    from financial_rag_tpu_torch.runtime import Runtime
    from financial_rag_tpu_torch.serving.app import run_server

    rt = Runtime.build(data_dir=args.data_dir)
    processor = rt.make_processor(args.data_dir)
    if args.auto_ingest or rt.config.ingest.auto_ingest:
        processor.start()
    app = rt.make_app(processor=processor, data_dir=args.data_dir)
    run_server(app, host=args.host or rt.config.serving.host,
               port=args.port or rt.config.serving.port)


if __name__ == "__main__":
    main()
