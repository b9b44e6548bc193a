"""Dense-path QA runner: ingest the most invoice-like extraction JSON, then
answer the golden questions through the pure-dense retriever and the LLM,
logging the payloads.

    python -m financial_rag_tpu_torch.scripts.pc_llm_answer [--dir "New folder"]
        [--data-dir .] [--log-dir chunk_logs]

The port's counterpart of the root ``scripts/pc_llm_answer.py``: the same
flags, lines and ``qa_llm_payload_*.json`` files, on the GPU
(``FRAG_PLATFORM=cpu`` for the CPU). With ``LLM_PROVIDER=local`` the
answers come from the checkpoint at ``LLM_CHECKPOINT`` on the same device.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

from financial_rag_tpu_torch.scripts.test_full_flow import GOLDEN_QUESTIONS

INVOICE_KEYWORDS = ["invoice", "gst", "tax", "amount", "total", "rent", "lease",
                    "credit note", "supplier", "bill"]


def invoice_score(path: Path) -> int:
    try:
        text = path.read_text(encoding="utf-8", errors="ignore").lower()
    except OSError:
        return 0
    return sum(text.count(kw) for kw in INVOICE_KEYWORDS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="New folder")
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--log-dir", default="chunk_logs")
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.llm.provider import synthesize_answer
    from financial_rag_tpu_torch.runtime import Runtime

    rt = Runtime.build(data_dir=args.data_dir)

    candidates = [p for p in Path(args.dir).rglob("*.json")
                  if not p.name.endswith("_meta.json")]
    if not candidates:
        print(f"no extraction JSONs under {args.dir}")
        return 0
    best = max(candidates, key=invoice_score)
    print(f"ingesting most invoice-like JSON: {best} (score {invoice_score(best)})")
    rt.pipeline.ingest_extracted_json(best, best.stem)

    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    for q in GOLDEN_QUESTIONS:
        out = rt.dense_retriever.query(q, top_k=8, dedup_parents=4)
        answer = synthesize_answer(rt.engine.llm, q, out["parent_contexts"])
        payload = {
            "question": q,
            "answer": answer,
            "child_hits": out["child_hits"],
            "parents": [p["parent_id"] for p in out["parent_contexts"]],
        }
        ts = time.strftime("%Y%m%d_%H%M%S")
        name = re.sub(r"[^a-z0-9]+", "_", q.lower()).strip("_")[:32]
        (log_dir / f"qa_llm_payload_{ts}_{name}.json").write_text(
            json.dumps(payload, indent=2, default=str))
        print(f"Q: {q}\n   -> {answer[:160]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
