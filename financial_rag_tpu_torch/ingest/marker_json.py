"""Marker-extraction JSON parsing.

Marker (the PDF extractor the reference shells out to) emits several JSON
shapes; this parser accepts all four the reference handles (reference
parent_child/pipeline.py:36-68) and yields a flat list of
{"content": str, "page": int} blocks:

  1. dict with a flat "blocks" list;
  2. dict with nested "children" (block tree; html on any node) — e.g. the
     bundled cn22-23.json fixture;
  3. list of docs, each with "pages" -> "blocks";
  4. bare list of block dicts (detected by a "page" key).

Improvement over the reference: in shape 2 the page number is recovered from
Marker block ids ("/page/<n>/<Type>/<k>"), which the reference ignores
(every block lands on page 0 there).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List

_PAGE_ID_RE = re.compile(r"^/page/(\d+)/")


def _page_from_id(node: dict, default: int) -> int:
    bid = node.get("id")
    if isinstance(bid, str):
        m = _PAGE_ID_RE.match(bid)
        if m:
            return int(m.group(1))
    page = node.get("page")
    if isinstance(page, int):
        return page
    return default


def _walk_children(node: dict, blocks: List[dict], page_hint: int) -> None:
    if not isinstance(node, dict):
        return
    page = _page_from_id(node, page_hint)
    text = node.get("html") or node.get("content")
    kids = node.get("children")
    has_kids = isinstance(kids, list) and len(kids) > 0
    # leaf html is real content; container html is <content-ref> plumbing
    if isinstance(text, str) and text.strip() and not (has_kids and "content-ref" in text):
        blocks.append({"content": text, "page": page})
    if has_kids:
        for ch in kids:
            _walk_children(ch, blocks, page)


def parse_marker_blocks(data) -> List[dict]:
    """Normalize any Marker JSON shape to [{'content', 'page'}, ...]."""
    blocks: List[dict] = []
    if isinstance(data, dict):
        if isinstance(data.get("blocks"), list):
            for b in data["blocks"]:
                blocks.append({
                    "content": b.get("content") or b.get("html") or "",
                    "page": int(b.get("page", 0) or 0),
                })
        elif isinstance(data.get("children"), list):
            _walk_children(data, blocks, 0)
    elif isinstance(data, list) and data:
        first = data[0] or {}
        if isinstance(first, dict) and "pages" in first:
            for doc in data:
                for page in doc.get("pages", []):
                    for b in page.get("blocks", []):
                        blocks.append({
                            "content": b.get("content") or b.get("html") or "",
                            "page": int(page.get("page_number") or b.get("page") or 0),
                        })
        elif isinstance(first, dict) and "page" in first:
            for b in data:
                blocks.append({
                    "content": b.get("content") or b.get("html") or "",
                    "page": int(b.get("page", 0) or 0),
                })
    return [b for b in blocks if isinstance(b["content"], str) and b["content"].strip()]


def parse_marker_json(path: str | Path) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        return parse_marker_blocks(json.load(f))
