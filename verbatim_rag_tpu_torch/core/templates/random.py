"""Randomized template strategy.

Parity: reference `verbatim_core/templates/random.py` — a pool of valid
templates, one picked per query; the pool can be the built-in defaults or an
LLM-generated diverse set.
"""

from __future__ import annotations

import logging
import random
from typing import Any

from .base import TemplateStrategy
from .filler import SpanData, TemplateFiller

logger = logging.getLogger(__name__)

DEFAULT_POOL = [
    "Here is what the source documents say:\n\n[DISPLAY_SPANS]\n\n[CITATION_REFS]",
    "## Relevant excerpts\n\n[DISPLAY_SPANS]\n\n[CITATION_REFS]",
    (
        "The following verbatim passages address the question:\n\n"
        "[DISPLAY_SPANS]\n\n---\n[CITATION_REFS]"
    ),
    "**Source material:**\n\n[DISPLAY_SPANS]\n\n[CITATION_REFS]",
    (
        "Directly quoted from the retrieved documents:\n\n"
        "[DISPLAY_SPANS]\n\n*All excerpts are verbatim.* [CITATION_REFS]"
    ),
]


class RandomTemplate(TemplateStrategy):
    """Pick a template at random from a pool for stylistic variety."""

    def __init__(
        self,
        templates: list[str] | None = None,
        llm_client=None,
        citation_mode: str = "inline",
        citation_format: str = "[{number}]",
        seed: int | None = None,
    ):
        self.llm_client = llm_client
        self.citation_mode = citation_mode
        self.filler = TemplateFiller(citation_mode=citation_mode, citation_format=citation_format)
        self._rng = random.Random(seed)
        self.templates = list(templates) if templates else list(DEFAULT_POOL)
        for t in self.templates:
            self.validate_template(t)

    def generate(self, question: str, spans: list[str], citation_count: int = 0) -> str:
        return self._rng.choice(self.templates)

    def fill(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        return self.filler.fill(template, display_spans, citation_spans)

    def add_template(self, template: str) -> None:
        self.validate_template(template)
        self.templates.append(template)

    def generate_pool(self, topic_hint: str = "", count: int = 5) -> None:
        """Use the LLM to refresh the pool with diverse templates."""
        if self.llm_client is None:
            raise ValueError("generate_pool requires an LLM client")
        try:
            generated = self.llm_client.generate_template_pool(topic_hint, count)
        except Exception as exc:
            logger.warning("Template pool generation failed, keeping pool: %s", exc)
            return
        fresh = []
        for t in generated:
            try:
                t = TemplateFiller.ensure_placeholder(t)
                self.validate_template(t)
                fresh.append(t)
            except ValueError:
                continue
        if fresh:
            self.templates = fresh

    def save_state(self) -> dict[str, Any]:
        return {"type": "random", "templates": list(self.templates)}

    def load_state(self, state: dict[str, Any]) -> None:
        templates = state.get("templates")
        if templates:
            self.templates = list(templates)

    def set_citation_mode(self, citation_mode: str) -> None:
        self.citation_mode = citation_mode
        self.filler.set_citation_mode(citation_mode)
