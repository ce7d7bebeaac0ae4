"""LLM-generated, per-question template strategy.

Parity: reference `verbatim_core/templates/contextual.py` — a template is
generated for each (question, spans) pair via the LLM client, memoized in a
bounded cache keyed on the question, repaired to always carry a placeholder,
and replaced by a safe fallback when generation fails.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any

from .base import TemplateStrategy
from .filler import SpanData, TemplateFiller

logger = logging.getLogger(__name__)

_CACHE_LIMIT = 100

FALLBACK_TEMPLATE = """Based on the retrieved documents, here is the relevant information:

[DISPLAY_SPANS]

[CITATION_REFS]"""


class ContextualTemplate(TemplateStrategy):
    """Ask the LLM to draft a response skeleton tailored to the question."""

    def __init__(
        self,
        llm_client,
        citation_mode: str = "inline",
        citation_format: str = "[{number}]",
        template_preview_chars: int = 100,
        preserve_span_newlines: bool = False,
        template_prompt: str | None = None,
        system_prompt: str | None = None,
    ):
        if llm_client is None:
            raise ValueError("ContextualTemplate requires an LLM client")
        self.llm_client = llm_client
        self.citation_mode = citation_mode
        self.filler = TemplateFiller(citation_mode=citation_mode, citation_format=citation_format)
        self.template_preview_chars = template_preview_chars
        self.preserve_span_newlines = preserve_span_newlines
        self.template_prompt = template_prompt
        self.system_prompt = system_prompt
        self._cache: dict[str, str] = {}

    # -- generation -----------------------------------------------------------

    def generate(self, question: str, spans: list[str], citation_count: int = 0) -> str:
        key = self._cache_key(question)
        if key in self._cache:
            return self._cache[key]
        try:
            template = self.llm_client.generate_template(
                question,
                spans,
                citation_count,
                preview_chars=self.template_preview_chars,
                preserve_span_newlines=self.preserve_span_newlines,
                template_prompt=self.template_prompt,
                system_prompt=self.system_prompt,
            )
            template = self._post_process(template, citation_count)
        except Exception as exc:  # degrade, never fail the query
            logger.warning("Contextual template generation failed: %s", exc)
            template = FALLBACK_TEMPLATE
        self._remember(key, template)
        return template

    async def generate_async(self, question: str, spans: list[str], citation_count: int = 0) -> str:
        key = self._cache_key(question)
        if key in self._cache:
            return self._cache[key]
        try:
            template = await self.llm_client.generate_template_async(
                question,
                spans,
                citation_count,
                preview_chars=self.template_preview_chars,
                preserve_span_newlines=self.preserve_span_newlines,
                template_prompt=self.template_prompt,
                system_prompt=self.system_prompt,
            )
            template = self._post_process(template, citation_count)
        except Exception as exc:
            logger.warning("Contextual template generation failed (async): %s", exc)
            template = FALLBACK_TEMPLATE
        self._remember(key, template)
        return template

    def _post_process(self, template: str, citation_count: int) -> str:
        template = TemplateFiller.ensure_placeholder(template)
        if citation_count > 0 and "[CITATION_REFS]" not in template:
            template += "\n\n[CITATION_REFS]"
        elif citation_count == 0 and "[CITATION_REFS]" in template:
            template = template.replace("[CITATION_REFS]", "").rstrip()
        return template

    # -- fill / persistence -----------------------------------------------------

    def fill(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        return self.filler.fill(template, display_spans, citation_spans)

    def save_state(self) -> dict[str, Any]:
        return {"type": "contextual", "cache": dict(self._cache)}

    def load_state(self, state: dict[str, Any]) -> None:
        cache = state.get("cache", {})
        if isinstance(cache, dict):
            self._cache = dict(list(cache.items())[-_CACHE_LIMIT:])

    def clear_cache(self) -> None:
        self._cache.clear()

    def set_citation_mode(self, citation_mode: str) -> None:
        self.citation_mode = citation_mode
        self.filler.set_citation_mode(citation_mode)

    # -- cache ------------------------------------------------------------------

    @staticmethod
    def _cache_key(question: str) -> str:
        return hashlib.md5(question.strip().lower().encode()).hexdigest()

    def _remember(self, key: str, template: str) -> None:
        if len(self._cache) >= _CACHE_LIMIT:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = template
