"""Golden-question full-flow runner: hybrid retrieve -> rerank -> parents ->
prompt -> LLM, with per-question JSON logs and token accounting.

    python -m financial_rag_tpu_torch.scripts.test_full_flow [--data-dir .]
        [--questions q1 q2 ...] [--log-dir test_logs]

The port's counterpart of the root ``scripts/test_full_flow.py``: the same
flags, lines and ``fullflow_<question>.json`` files, on the GPU
(``FRAG_PLATFORM=cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

GOLDEN_QUESTIONS = [
    "What is the rent for the first year?",
    "What is the lock-in period?",
    "Who is the lessor?",
    "What is the total invoice amount?",
    "What is the GST amount?",
]


def slug(text: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", text.lower()).strip("_")[:40]


def approx_tokens(text: str) -> int:
    return int(len(re.findall(r"\w+", text)) * 1.3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=".")
    ap.add_argument("--questions", nargs="*", default=GOLDEN_QUESTIONS)
    ap.add_argument("--log-dir", default="test_logs")
    args = ap.parse_args(argv)

    from financial_rag_tpu_torch.runtime import Runtime

    rt = Runtime.build(data_dir=args.data_dir)
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)

    for q in args.questions:
        t0 = time.time()
        result = rt.engine.query(q)
        elapsed = time.time() - t0
        top3 = result.get("top_children_chunks", [])[:3]
        payload = {
            "question": q,
            "answer": result.get("answer"),
            "elapsed_s": round(elapsed, 3),
            "queries": [result.get("corrected_query")] + result.get("multiqueries", []),
            "top_children": [
                {"child_id": c.get("child_id"),
                 "retrieval_score": c.get("retrieval_score"),
                 "final_rerank_score": c.get("final_rerank_score"),
                 "text": c.get("text")}
                for c in top3
            ],
            "parents": [
                {"parent_id": p.get("parent_id"), "document": p.get("document_id"),
                 "tokens": approx_tokens(p.get("text", ""))}
                for p in result.get("chunks", [])
            ],
            "token_accounting": {
                "prompt_tokens": approx_tokens(result.get("llm_prompt", "")),
                "answer_tokens": approx_tokens(result.get("answer", "")),
                "context_tokens": sum(approx_tokens(p.get("text", ""))
                                      for p in result.get("chunks", [])),
            },
        }
        out = log_dir / f"fullflow_{slug(q)}.json"
        out.write_text(json.dumps(payload, indent=2, default=str))
        print(f"Q: {q}\n   -> {result.get('answer', '')[:160]!r}\n"
              f"   ({elapsed:.2f}s, log: {out})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
