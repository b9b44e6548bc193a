"""UI response formatting.

Produces the exact shapes the reference React UI consumes
(reference api_server.py:551-809, amber-ai-search/types.ts:26-61):
DocumentResult cards from child/parent chunks, and the structured
AiResponse {summary, items[{title, text, references}]} with HTML converted
to markdown (tables included).
"""

from __future__ import annotations

import os
import re
from datetime import datetime
from typing import Any, Dict, List, Optional

EXT_TO_UI_TYPE = {
    "pdf": "pdf",
    "doc": "word", "docx": "word",
    "xls": "excel", "xlsx": "excel", "csv": "excel",
    "ppt": "ppt", "pptx": "ppt",
    "txt": "txt", "md": "txt",
    "htm": "html", "html": "html",
    "eml": "email", "msg": "email",
    "zip": "compressed", "tar": "compressed", "gz": "compressed",
    "rar": "compressed", "7z": "compressed",
    "json": "json",
    "png": "image", "jpg": "image", "jpeg": "image", "gif": "image",
    "tif": "image", "tiff": "image", "bmp": "image",
}


def _ui_file_type(path: Optional[str]) -> str:
    if not path:
        return "unknown"
    ext = os.path.splitext(str(path))[1].lstrip(".").lower()
    return EXT_TO_UI_TYPE.get(ext, ext or "unknown")


def format_chunks_for_ui(chunks: List[Any]) -> List[dict]:
    """Backend chunks -> UI DocumentResult list."""
    documents: List[dict] = []
    for i, chunk in enumerate(chunks):
        if isinstance(chunk, str):
            documents.append({
                "id": f"doc_{i}",
                "sourceType": "Windows Shares",
                "sourcePath": "Text Content",
                "fileType": "txt",
                "title": f"Text Document {i + 1}",
                "date": "Unknown",
                "snippet": chunk,
                "author": "System",
                "score": 0.0,
            })
            continue
        if not isinstance(chunk, dict):
            continue
        chunk_id = chunk.get("child_id") or chunk.get("chunk_id") or chunk.get("id", f"doc_{i}")
        document_name = (chunk.get("document_id") or chunk.get("document_name")
                         or chunk.get("source") or "Unknown Document")
        source_path = (chunk.get("source_path") or chunk.get("document_path")
                       or chunk.get("path") or str(document_name))
        text = chunk.get("text") or chunk.get("chunk_text") or chunk.get("content") or ""
        mtime = chunk.get("source_mtime")
        date = datetime.fromtimestamp(mtime).strftime("%d.%m.%Y") if mtime else "Unknown"
        score = chunk.get("final_rerank_score",
                          chunk.get("retrieval_score", chunk.get("score", 0.0)))
        documents.append({
            "id": str(chunk_id),
            "sourceType": "Windows Shares",
            "sourcePath": str(source_path),
            "fileType": _ui_file_type(source_path),
            "title": os.path.basename(str(document_name)) or f"Document {i + 1}",
            "date": date,
            "snippet": text,
            "author": "System",
            "score": float(score or 0.0),
        })
    return documents


# ------------------------------------------------------- HTML -> markdown

def _table_to_markdown(match: re.Match) -> str:
    rows = re.findall(r"<tr>(.*?)</tr>", match.group(1), flags=re.DOTALL)
    md: List[str] = []
    for i, row in enumerate(rows):
        cells = re.findall(r"<t[hd][^>]*>(.*?)</t[hd]>", row, flags=re.DOTALL)
        if not cells:
            continue
        clean = [re.sub(r"<[^>]+>", "", c).strip() for c in cells]
        md.append("| " + " | ".join(clean) + " |")
        if i == 0:
            md.append("| " + " | ".join(["---"] * len(clean)) + " |")
    return "\n".join(md) + "\n\n"


def html_to_markdown(text: str) -> str:
    t = re.sub(r"<p>(.*?)</p>", r"\1\n\n", text, flags=re.DOTALL)
    t = re.sub(r"<table[^>]*>(.*?)</table>", _table_to_markdown, t, flags=re.DOTALL)
    t = re.sub(r"<tr>(.*?)</tr>", r"\1\n", t, flags=re.DOTALL)
    t = re.sub(r"<t[hd][^>]*>(.*?)</t[hd]>", r"| \1 ", t, flags=re.DOTALL)
    t = re.sub(r"<(strong|b)>(.*?)</\1>", r"**\2**", t, flags=re.DOTALL)
    t = re.sub(r"<li>(.*?)</li>", r"• \1\n", t, flags=re.DOTALL)
    t = re.sub(r"<[uo]l[^>]*>(.*?)</[uo]l>", r"\1\n", t, flags=re.DOTALL)
    t = re.sub(r"<[^>]+>", "", t)
    t = re.sub(r"[ \t]+", " ", t)
    t = re.sub(r"\n\s*\n\s*\n+", "\n\n", t)
    return t.strip()


def format_ai_response(raw: str, documents: Optional[List[dict]] = None) -> dict:
    """Raw answer -> AiResponse {summary, items}.

    ``references`` is the reference UI's AiReference wire shape —
    ``[{"id": N, "docId": <documents[N-1].id>}]`` (api_server.py:1147,
    amber-ai-search types.ts AiReference) — so the React AiAnswer's
    ``ref.id`` chip label and ``ref.docId`` click-to-scroll work unchanged.
    [N] citation markers in the answer pick the cited documents; with no
    markers, the first five documents are cited, matching the reference.
    """
    if not raw or not raw.strip():
        return {"summary": "No response generated", "items": []}
    cleaned = html_to_markdown(raw)
    if len(cleaned) > 10000:
        cut = 9500
        while cut < len(cleaned) and cleaned[cut] not in "\n\r":
            cut += 1
        cleaned = cleaned[:cut] + "\n\n[Response truncated for display...]"
    lines = [ln.strip() for ln in cleaned.split("\n") if ln.strip()]
    summary = lines[0] if lines else cleaned[:100]
    if len(summary) > 150:
        summary = summary[:147] + "..."
    # [N]-style citation markers in the answer become 1-based references
    # into the documents list (the wire shape the reference UI's
    # click-to-scroll consumes, amber-ai-search App.tsx:154-166 / types.ts)
    nums = sorted({int(m) for m in re.findall(r"\[(\d{1,2})\]", cleaned)
                   if 1 <= int(m) <= 50})
    if not nums and documents:
        nums = list(range(1, min(5, len(documents)) + 1))
    if documents is not None:
        nums = [n for n in nums if n <= len(documents)]

    def _doc_id(n: int) -> str:
        if documents and n <= len(documents):
            return str(documents[n - 1].get("id", f"doc_{n - 1}"))
        return f"doc_{n - 1}"   # format_chunks_for_ui's 0-based default ids

    refs = [{"id": n, "docId": _doc_id(n)} for n in nums]
    return {
        "summary": summary,
        "items": [{"title": "Analysis Results", "text": cleaned, "references": refs}],
    }
