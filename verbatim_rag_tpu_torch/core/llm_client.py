"""OpenAI-compatible chat client used for prompted extraction and templating.

Parity: reference `verbatim_core/llm_client.py` — one client object exposing
sync + async completion, batch span extraction, structured (per-placeholder)
extraction with document attribution, and template generation with per-fact
(≤8 spans) vs aggregate prompt selection.

Implementation difference: the reference wraps the ``openai`` SDK; this build
talks to the REST endpoint directly over ``httpx`` (works identically against
OpenAI, vLLM, Groq, or any `/chat/completions`-compatible server), which keeps
the dependency surface small and lets the serving layer pool connections.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any

import httpx

logger = logging.getLogger(__name__)

_DEFAULT_TIMEOUT = httpx.Timeout(60.0, connect=10.0)


def _retryable(exc: Exception) -> bool:
    """Retry transport errors and 408/429/5xx; 4xx client errors are doomed —
    re-sending the identical request only delays the failure."""
    if isinstance(exc, httpx.HTTPStatusError):
        status = exc.response.status_code
        return status in (408, 429) or status >= 500
    return isinstance(exc, httpx.TransportError)


#: exponential backoff base: 0.5, 1, 2, 4... seconds between retries.
_BACKOFF_BASE_S = 0.5
_BACKOFF_MAX_S = 16.0


def _retry_delay_s(attempt: int, exc: Exception) -> float:
    """Seconds to wait before retry `attempt` — honors Retry-After when the
    server sent one (429s in particular), else exponential backoff. Without
    a delay the retry loop burns every attempt within milliseconds, which
    makes 'retrying' rate limits meaningless."""
    if isinstance(exc, httpx.HTTPStatusError):
        retry_after = exc.response.headers.get("Retry-After")
        if retry_after:
            try:
                return min(float(retry_after), 60.0)
            except ValueError:
                pass  # HTTP-date form: fall through to backoff
    return min(_BACKOFF_BASE_S * (2**attempt), _BACKOFF_MAX_S)


class LLMClient:
    """All LLM traffic in the framework flows through this object."""

    def __init__(
        self,
        model: str = "gpt-4o-mini",
        temperature: float = 0.7,
        api_base: str = "https://api.openai.com/v1",
        api_key: str | None = None,
        max_retries: int = 2,
    ):
        self.model = model
        self.temperature = temperature
        self.api_base = api_base.rstrip("/")
        self.api_key = api_key or os.getenv("OPENAI_API_KEY") or "EMPTY"
        self.max_retries = max_retries
        self._client: httpx.Client | None = None
        self._async_client: httpx.AsyncClient | None = None

    # -- transport ---------------------------------------------------------------

    def _headers(self) -> dict[str, str]:
        return {
            "Authorization": f"Bearer {self.api_key}",
            "Content-Type": "application/json",
        }

    def _payload(
        self,
        prompt: str,
        json_mode: bool,
        temperature: float | None,
        system_prompt: str | None,
    ) -> dict[str, Any]:
        messages: list[dict[str, str]] = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": prompt})
        payload: dict[str, Any] = {
            "model": self.model,
            "messages": messages,
            "temperature": self.temperature if temperature is None else temperature,
        }
        if json_mode:
            payload["response_format"] = {"type": "json_object"}
        return payload

    @staticmethod
    def _extract_content(data: dict[str, Any]) -> str:
        choices = data.get("choices") or []
        if not choices or choices[0].get("message") is None:
            raise ValueError("LLM returned empty or filtered response")
        content = choices[0]["message"].get("content")
        if content is None:
            raise ValueError("LLM returned empty or filtered response")
        return content

    def _sync_client(self) -> httpx.Client:
        if self._client is None:
            self._client = httpx.Client(timeout=_DEFAULT_TIMEOUT)
        return self._client

    def _get_async_client(self) -> httpx.AsyncClient:
        if self._async_client is None:
            self._async_client = httpx.AsyncClient(timeout=_DEFAULT_TIMEOUT)
        return self._async_client

    # -- completion ---------------------------------------------------------------

    def complete(
        self,
        prompt: str,
        json_mode: bool = False,
        temperature: float | None = None,
        system_prompt: str | None = None,
    ) -> str:
        payload = self._payload(prompt, json_mode, temperature, system_prompt)
        url = f"{self.api_base}/chat/completions"
        last_error: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                resp = self._sync_client().post(url, json=payload, headers=self._headers())
                resp.raise_for_status()
                return self._extract_content(resp.json())
            except (httpx.TransportError, httpx.HTTPStatusError) as exc:
                if not _retryable(exc):
                    raise
                last_error = exc
                logger.warning("LLM request failed (attempt %d): %s", attempt + 1, exc)
                if attempt < self.max_retries:
                    time.sleep(_retry_delay_s(attempt, exc))
        raise last_error  # type: ignore[misc]

    async def complete_async(
        self,
        prompt: str,
        json_mode: bool = False,
        temperature: float | None = None,
        system_prompt: str | None = None,
    ) -> str:
        payload = self._payload(prompt, json_mode, temperature, system_prompt)
        url = f"{self.api_base}/chat/completions"
        last_error: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                resp = await self._get_async_client().post(
                    url, json=payload, headers=self._headers()
                )
                resp.raise_for_status()
                return self._extract_content(resp.json())
            except (httpx.TransportError, httpx.HTTPStatusError) as exc:
                if not _retryable(exc):
                    raise
                last_error = exc
                logger.warning("Async LLM request failed (attempt %d): %s", attempt + 1, exc)
                if attempt < self.max_retries:
                    await asyncio.sleep(_retry_delay_s(attempt, exc))
        raise last_error  # type: ignore[misc]

    # -- span extraction ------------------------------------------------------------

    def extract_spans(self, question: str, documents: dict[str, str]) -> dict[str, list[str]]:
        """Batch verbatim-span extraction: doc_id -> ordered spans."""
        prompt = self._build_extraction_prompt(question, documents)
        try:
            raw = json.loads(self.complete(prompt, json_mode=True))
            # json_mode-lax servers can return a top-level array/scalar —
            # valid JSON that would crash callers expecting a mapping.
            if not isinstance(raw, dict):
                raise ValueError(f"expected JSON object, got {type(raw).__name__}")
            return raw
        except (json.JSONDecodeError, KeyError, ValueError) as exc:
            logger.warning("Span extraction failed: %s", exc)
            return {doc_id: [] for doc_id in documents}

    async def extract_spans_async(
        self, question: str, documents: dict[str, str]
    ) -> dict[str, list[str]]:
        prompt = self._build_extraction_prompt(question, documents)
        try:
            raw = json.loads(await self.complete_async(prompt, json_mode=True))
            if not isinstance(raw, dict):
                raise ValueError(f"expected JSON object, got {type(raw).__name__}")
            return raw
        except (json.JSONDecodeError, KeyError, ValueError) as exc:
            logger.warning("Async span extraction failed: %s", exc)
            return {doc_id: [] for doc_id in documents}

    def extract_relevant_spans_batch(
        self, question: str, documents: dict[str, str]
    ) -> dict[str, list[str]]:
        return self.extract_spans(question, documents)

    async def extract_relevant_spans_batch_async(
        self, question: str, documents: dict[str, str]
    ) -> dict[str, list[str]]:
        return await self.extract_spans_async(question, documents)

    def extract_relevant_spans(self, question: str, document_text: str) -> list[str]:
        return self.extract_relevant_spans_batch(question, {"doc": document_text}).get("doc", [])

    async def extract_relevant_spans_async(self, question: str, document_text: str) -> list[str]:
        result = await self.extract_relevant_spans_batch_async(question, {"doc": document_text})
        return result.get("doc", [])

    # -- structured extraction --------------------------------------------------------

    def extract_structured(
        self,
        question: str,
        template: str,
        placeholders: dict[str, str],
        documents: list[str],
    ) -> dict[str, list[dict[str, Any]]]:
        """Per-placeholder extraction with doc attribution."""
        prompt = self._build_structured_extraction_prompt(
            question, template, placeholders, documents
        )
        try:
            raw = json.loads(self.complete(prompt, json_mode=True))
            return self._normalize_structured_response(raw, placeholders)
        except (json.JSONDecodeError, KeyError) as exc:
            logger.warning("Structured extraction failed: %s", exc)
            return {name: [] for name in placeholders}

    async def extract_structured_async(
        self,
        question: str,
        template: str,
        placeholders: dict[str, str],
        documents: list[str],
    ) -> dict[str, list[dict[str, Any]]]:
        prompt = self._build_structured_extraction_prompt(
            question, template, placeholders, documents
        )
        try:
            raw = json.loads(await self.complete_async(prompt, json_mode=True))
            return self._normalize_structured_response(raw, placeholders)
        except (json.JSONDecodeError, KeyError) as exc:
            logger.warning("Structured extraction failed: %s", exc)
            return {name: [] for name in placeholders}

    @staticmethod
    def _normalize_structured_response(
        response: dict, placeholders: dict[str, str]
    ) -> dict[str, list[dict[str, Any]]]:
        """Accept both bare-string and {text, doc} item shapes."""
        normalized: dict[str, list[dict[str, Any]]] = {}
        if not isinstance(response, dict):
            # Top-level array/scalar from a json_mode-lax server: treat as
            # no extractions rather than crash the caller.
            return {name: [] for name in placeholders}
        for name in placeholders:
            items = response.get(name, [])
            if not isinstance(items, list):
                items = []
            cleaned = []
            for item in items:
                if isinstance(item, str):
                    cleaned.append({"text": item, "doc": 0})
                elif isinstance(item, dict) and "text" in item:
                    cleaned.append({"text": item["text"], "doc": item.get("doc", 0)})
            normalized[name] = cleaned
        return normalized

    # -- template generation -------------------------------------------------------------

    def generate_template(
        self,
        question: str,
        spans: list[str],
        citation_count: int,
        use_per_fact: bool = True,
        preview_chars: int | None = 100,
        preserve_span_newlines: bool = False,
        template_prompt: str | None = None,
        system_prompt: str | None = None,
    ) -> str:
        prompt = self._template_prompt(
            question,
            spans,
            citation_count,
            use_per_fact,
            preview_chars,
            preserve_span_newlines,
            template_prompt,
        )
        try:
            return self.complete(prompt, system_prompt=system_prompt)
        except Exception as exc:
            logger.error("Template generation failed: %s", exc)
            return self._fallback_template(citation_count > 0)

    async def generate_template_async(
        self,
        question: str,
        spans: list[str],
        citation_count: int,
        use_per_fact: bool = True,
        preview_chars: int | None = 100,
        preserve_span_newlines: bool = False,
        template_prompt: str | None = None,
        system_prompt: str | None = None,
    ) -> str:
        prompt = self._template_prompt(
            question,
            spans,
            citation_count,
            use_per_fact,
            preview_chars,
            preserve_span_newlines,
            template_prompt,
        )
        try:
            return await self.complete_async(prompt, system_prompt=system_prompt)
        except Exception as exc:
            logger.error("Async template generation failed: %s", exc)
            return self._fallback_template(citation_count > 0)

    def generate_template_pool(self, topic_hint: str = "", count: int = 5) -> list[str]:
        """Ask for a diverse pool of aggregate templates (used by RandomTemplate)."""
        prompt = (
            f"Write {count} distinct response templates for presenting verbatim quotes"
            + (f" about {topic_hint}" if topic_hint else "")
            + ". Each template must contain [DISPLAY_SPANS] exactly once and may "
            "contain [CITATION_REFS] once. Respond with ONLY a JSON object: "
            '{"templates": ["...", "..."]}'
        )
        raw = json.loads(self.complete(prompt, json_mode=True))
        templates = raw.get("templates", [])
        return [t for t in templates if isinstance(t, str)]

    # -- prompt builders ------------------------------------------------------------------

    def _build_extraction_prompt(self, question: str, documents: dict[str, str]) -> str:
        from .prompts import load_prompt

        return load_prompt(
            "extraction/default",
            question=question,
            documents=json.dumps(documents, indent=2),
        )

    def _build_structured_extraction_prompt(
        self,
        question: str,
        template: str,
        placeholders: dict[str, str],
        documents: list[str],
    ) -> str:
        from .prompts import load_prompt

        placeholder_spec = "\n".join(f"- {name}: {hint}" for name, hint in placeholders.items())
        docs_text = "\n\n---\n\n".join(f"[Document {i}]\n{doc}" for i, doc in enumerate(documents))
        return load_prompt(
            "extraction/structured",
            question=question,
            template=template,
            placeholder_spec=placeholder_spec,
            docs_text=docs_text,
        )

    def _template_prompt(
        self,
        question: str,
        spans: list[str],
        citation_count: int,
        use_per_fact: bool,
        preview_chars: int | None,
        preserve_span_newlines: bool,
        template_prompt: str | None,
    ) -> str:
        from .prompts import load_prompt, render_prompt

        per_fact = use_per_fact and len(spans) <= 8
        if per_fact:
            lines = []
            for i, span in enumerate(spans, start=1):
                text = span if preserve_span_newlines else span.replace("\n", " ")
                text = text.strip()
                if preview_chars is not None:
                    text = text[:preview_chars] + "..."
                lines.append(f"{i}. {text}")
            ctx = dict(
                question=question,
                n_spans=len(spans),
                spans_block="\n".join(lines),
                citation_count=citation_count,
            )
            name = "template/per_fact"
        else:
            limit = 50 if preview_chars is None else min(50, preview_chars)
            previews = []
            for span in spans[:3]:
                text = span if preserve_span_newlines else span.replace("\n", " ")
                previews.append(text[:limit] + "...")
            ctx = dict(
                question=question,
                n_spans=len(spans),
                span_preview=" | ".join(previews),
                citation_count=citation_count,
            )
            name = "template/aggregate"

        if template_prompt is not None:
            return render_prompt(template_prompt, **ctx)
        return load_prompt(name, **ctx)

    def _fallback_template(self, has_citations: bool = False) -> str:
        from .prompts import load_prompt

        return load_prompt("template/fallback", has_citations=has_citations)

    # -- convenience aliases -----------------------------------------------------------

    def simple_complete(self, prompt: str) -> str:
        return self.complete(prompt)

    async def simple_complete_async(self, prompt: str) -> str:
        return await self.complete_async(prompt)
