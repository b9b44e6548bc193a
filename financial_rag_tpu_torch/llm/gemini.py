"""Gemini HTTP provider (capability of reference rag_backend.py:417-462:
POST generateContent, 3 retries with backoff, graceful None on failure)."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Optional

from financial_rag_tpu_torch.config import LLMConfig
from financial_rag_tpu_torch.utils import get_logger

log = get_logger("llm.gemini")


class GeminiProvider:
    name = "gemini"

    def __init__(self, cfg: LLMConfig) -> None:
        self.cfg = cfg

    def available(self) -> bool:
        return bool(self.cfg.gemini_api_key)

    def generate(self, prompt: str, *, max_tokens: int = 1024) -> Optional[str]:
        if not self.available():
            return None
        body = json.dumps({
            "contents": [{"parts": [{"text": prompt}]}],
            "generationConfig": {"maxOutputTokens": max_tokens, "temperature": 0.2},
        }).encode("utf-8")
        url = f"{self.cfg.gemini_api_url}?key={self.cfg.gemini_api_key}"
        for attempt in range(self.cfg.retries):
            try:
                req = urllib.request.Request(
                    url, data=body, headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.cfg.timeout_s) as resp:
                    data = json.loads(resp.read().decode("utf-8"))
                candidates = data.get("candidates") or []
                if candidates:
                    parts = candidates[0].get("content", {}).get("parts", [])
                    text = "".join(p.get("text", "") for p in parts)
                    if text:
                        return text
                return None
            except (urllib.error.URLError, TimeoutError, json.JSONDecodeError, OSError) as e:
                log.warning("gemini call failed (attempt %d/%d): %s",
                            attempt + 1, self.cfg.retries, e)
                time.sleep(self.cfg.retry_sleep_s)
        return None
