"""Span extractors (copy of `verbatim_rag_tpu/core/extractors.py`).

The `SpanExtractor` contract (``extract_spans(question, results) ->
{doc_text: [span, ...]}`` with a to-thread async default) and the prompted
`LLMSpanExtractor`: batch / individual / auto modes, chunked batching with
per-chunk fallback to individual calls, concurrent async extraction, custom
Jinja2 prompts, and exact / fuzzy span verification. The neural extractors
live in `verbatim_rag_tpu_torch.models.highlighter`; ``ModelSpanExtractor``
and ``SemanticHighlightExtractor`` are re-exported from here lazily.

The offline path imports this module, so the LLM client (httpx) and span
verification are imported where they are used, not with the module.
"""

from __future__ import annotations

import asyncio
import json
import logging
from abc import ABC, abstractmethod
from typing import Any

logger = logging.getLogger(__name__)

SpanMap = dict[str, list[str]]


class SpanExtractor(ABC):
    """Find verbatim spans answering `question` inside each search result."""

    @abstractmethod
    def extract_spans(self, question: str, search_results: list[Any]) -> SpanMap:
        """:return: mapping from each result's original text to its spans."""

    async def extract_spans_async(self, question: str, search_results: list[Any]) -> SpanMap:
        """Default async implementation: push the sync path to a thread."""
        return await asyncio.to_thread(self.extract_spans, question, search_results)


class LLMSpanExtractor(SpanExtractor):
    """Prompted extraction through an OpenAI-compatible LLM, with verification."""

    def __init__(
        self,
        llm_client=None,
        model: str = "gpt-4o-mini",
        extraction_mode: str = "auto",
        max_display_spans: int = 5,
        batch_size: int = 5,
        span_match_mode: str = "exact",
        fuzzy_threshold: float = 0.8,
        extraction_prompt: str | None = None,
        system_prompt: str | None = None,
    ):
        if span_match_mode not in ("exact", "fuzzy"):
            raise ValueError(
                f"span_match_mode must be 'exact' or 'fuzzy', got {span_match_mode!r}"
            )
        if extraction_mode not in ("batch", "individual", "auto"):
            raise ValueError(
                f"extraction_mode must be 'batch', 'individual' or 'auto', got {extraction_mode!r}"
            )
        if llm_client is None:
            from .llm_client import LLMClient

            llm_client = LLMClient(model)
        self.llm_client = llm_client
        self.extraction_mode = extraction_mode
        self.max_display_spans = max_display_spans
        self.batch_size = batch_size
        self.span_match_mode = span_match_mode
        self.fuzzy_threshold = fuzzy_threshold
        self.extraction_prompt = extraction_prompt
        self.system_prompt = system_prompt

    # -- mode selection -----------------------------------------------------------

    def _use_batch(self, n_results: int) -> bool:
        return self.extraction_mode == "batch" or (
            self.extraction_mode == "auto" and n_results <= self.batch_size
        )

    # -- sync ----------------------------------------------------------------------

    def extract_spans(self, question: str, search_results: list[Any]) -> SpanMap:
        if not search_results:
            return {}
        if self._use_batch(len(search_results)):
            return self._extract_batch(question, search_results)
        return self._extract_individual(question, search_results)

    def _extract_batch(self, question: str, search_results: list[Any]) -> SpanMap:
        out: SpanMap = {}
        for offset in range(0, len(search_results), self.batch_size):
            chunk = search_results[offset : offset + self.batch_size]
            texts = {f"doc_{i}": getattr(r, "text", "") for i, r in enumerate(chunk)}
            try:
                extracted = self._call_batch(question, texts)
                for i, result in enumerate(chunk):
                    text = getattr(result, "text", "")
                    out[text] = self._verify(extracted.get(f"doc_{i}", []), text)
            except Exception as exc:
                logger.warning(
                    "Batch extraction failed for chunk at %d, retrying individually: %s",
                    offset,
                    exc,
                )
                for result in chunk:
                    text = getattr(result, "text", "")
                    try:
                        out[text] = self._verify(self._call_single(question, text), text)
                    except Exception as inner:
                        logger.error("Individual fallback extraction failed: %s", inner)
                        out[text] = []
        return out

    def _extract_individual(self, question: str, search_results: list[Any]) -> SpanMap:
        out: SpanMap = {}
        for result in search_results:
            text = getattr(result, "text", "")
            try:
                out[text] = self._verify(self._call_single(question, text), text)
            except Exception as exc:
                logger.error("Individual extraction failed: %s", exc)
                out[text] = []
        return out

    # -- async ------------------------------------------------------------------------

    async def extract_spans_async(self, question: str, search_results: list[Any]) -> SpanMap:
        if not search_results:
            return {}
        if self._use_batch(len(search_results)):
            return await self._extract_batch_async(question, search_results)
        return await self._extract_individual_async(question, search_results)

    async def _extract_batch_async(self, question: str, search_results: list[Any]) -> SpanMap:
        out: SpanMap = {}
        for offset in range(0, len(search_results), self.batch_size):
            chunk = search_results[offset : offset + self.batch_size]
            texts = {f"doc_{i}": getattr(r, "text", "") for i, r in enumerate(chunk)}
            try:
                extracted = await self._call_batch_async(question, texts)
                for i, result in enumerate(chunk):
                    text = getattr(result, "text", "")
                    out[text] = self._verify(extracted.get(f"doc_{i}", []), text)
            except Exception as exc:
                logger.warning("Async batch extraction failed, retrying individually: %s", exc)
                fallback = await self._extract_individual_async(question, chunk)
                out.update(fallback)
        return out

    async def _extract_individual_async(self, question: str, search_results: list[Any]) -> SpanMap:
        async def one(result: Any) -> tuple[str, list[str]]:
            text = getattr(result, "text", "")
            try:
                spans = await self._call_single_async(question, text)
                return text, self._verify(spans, text)
            except Exception as exc:
                logger.error("Async individual extraction failed: %s", exc)
                return text, []

        pairs = await asyncio.gather(*[one(r) for r in search_results])
        return dict(pairs)

    # -- LLM calls ----------------------------------------------------------------------

    def _call_batch(self, question: str, documents: dict[str, str]) -> dict[str, list[str]]:
        if self.extraction_prompt:
            prompt = self._render_custom_prompt(question, documents)
            return json.loads(
                self.llm_client.complete(prompt, json_mode=True, system_prompt=self.system_prompt)
            )
        return self.llm_client.extract_spans(question, documents)

    async def _call_batch_async(
        self, question: str, documents: dict[str, str]
    ) -> dict[str, list[str]]:
        if self.extraction_prompt:
            prompt = self._render_custom_prompt(question, documents)
            response = await self.llm_client.complete_async(
                prompt, json_mode=True, system_prompt=self.system_prompt
            )
            return json.loads(response)
        return await self.llm_client.extract_spans_async(question, documents)

    def _call_single(self, question: str, text: str) -> list[str]:
        if self.extraction_prompt:
            prompt = self._render_custom_prompt(question, {"doc_0": text})
            response = self.llm_client.complete(
                prompt, json_mode=True, system_prompt=self.system_prompt
            )
            return json.loads(response).get("doc_0", [])
        return self.llm_client.extract_relevant_spans(question, text)

    async def _call_single_async(self, question: str, text: str) -> list[str]:
        if self.extraction_prompt:
            prompt = self._render_custom_prompt(question, {"doc_0": text})
            response = await self.llm_client.complete_async(
                prompt, json_mode=True, system_prompt=self.system_prompt
            )
            return json.loads(response).get("doc_0", [])
        return await self.llm_client.extract_relevant_spans_async(question, text)

    def _render_custom_prompt(self, question: str, documents: dict[str, str]) -> str:
        from .prompts import render_prompt

        docs_formatted = "\n\n".join(f"[{doc_id}]\n{text}" for doc_id, text in documents.items())
        return render_prompt(self.extraction_prompt, question=question, documents=docs_formatted)

    # -- verification ----------------------------------------------------------------------

    def _verify_spans(self, spans: list[str], document_text: str) -> list[str]:
        return self._verify(spans, document_text)

    def _verify(self, spans: list[str], document_text: str) -> list[str]:
        from .span_verify import verify_spans

        return verify_spans(
            spans,
            document_text,
            mode=self.span_match_mode,
            fuzzy_threshold=self.fuzzy_threshold,
        )


def __getattr__(name: str):
    # Lazy re-export of the model-backed extractors; keeps core torch-free.
    if name in ("ModelSpanExtractor", "SemanticHighlightExtractor"):
        from verbatim_rag_tpu_torch.models import highlighter

        return getattr(highlighter, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
