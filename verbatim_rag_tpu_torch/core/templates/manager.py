"""Unified facade over the template strategies.

Parity: reference `verbatim_core/templates/manager.py` — strategy registry
{static, contextual, random, question_specific, structured}, mode switching
with LLM-availability fallback, one-shot ``process`` (generate + fill),
linked-citation input shaping, and JSON persistence of all strategy states.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

from .base import TemplateStrategy
from .contextual import ContextualTemplate
from .filler import SpanData
from .question_specific import QuestionSpecificTemplate
from .random import RandomTemplate
from .static import StaticTemplate
from .structured import StructuredTemplate

logger = logging.getLogger(__name__)


class TemplateManager:
    """Owns one instance of every available strategy and the active mode."""

    def __init__(
        self,
        llm_client=None,
        default_mode: str = "static",
        rag_system=None,
        citation_mode: str = "inline",
        citation_format: str = "[{number}]",
    ):
        self.llm_client = llm_client
        self.rag_system = rag_system
        self.citation_mode = citation_mode
        self.citation_format = citation_format

        self.strategies: dict[str, TemplateStrategy | None] = {
            "static": StaticTemplate(citation_mode=citation_mode, citation_format=citation_format),
            "contextual": (
                ContextualTemplate(
                    llm_client, citation_mode=citation_mode, citation_format=citation_format
                )
                if llm_client
                else None
            ),
            "random": RandomTemplate(
                llm_client=llm_client, citation_mode=citation_mode, citation_format=citation_format
            ),
            "question_specific": QuestionSpecificTemplate(
                citation_mode=citation_mode, citation_format=citation_format
            ),
            "structured": StructuredTemplate(rag_system=rag_system, citation_mode=citation_mode),
        }

        self.current_mode = default_mode if default_mode in self.strategies else "static"
        if self.strategies[self.current_mode] is None:
            logger.warning(
                "%s mode requires an LLM client; falling back to static", self.current_mode
            )
            self.current_mode = "static"

    # -- mode management ----------------------------------------------------------

    def set_mode(self, mode: str) -> bool:
        if mode not in self.strategies:
            logger.warning("Unknown template mode: %s", mode)
            return False
        if self.strategies[mode] is None:
            logger.warning("Mode %s is not available (requires LLM client)", mode)
            return False
        self.current_mode = mode
        return True

    def get_current_mode(self) -> str:
        return self.current_mode

    def get_available_modes(self) -> list[str]:
        return [m for m, s in self.strategies.items() if s is not None]

    @property
    def strategy(self) -> TemplateStrategy:
        return self.strategies[self.current_mode]

    # -- processing ---------------------------------------------------------------

    def resolve_mode(self, mode: str | None) -> str:
        """A per-query mode override, falling back to the active mode when
        the override is unknown or unavailable (e.g. needs an LLM client)."""
        if mode and mode in self.strategies and self.strategies[mode] is not None:
            return mode
        if mode:
            logger.warning(
                "Requested template mode %r unavailable; using %s",
                mode, self.current_mode,
            )
        return self.current_mode

    def process(
        self,
        question: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
        mode: str | None = None,
    ) -> str:
        all_spans, citation_count = self._get_template_inputs(display_spans, citation_spans)
        strategy = self.strategies[self.resolve_mode(mode)]
        template = strategy.generate(question, all_spans, citation_count)
        return strategy.fill(template, display_spans, citation_spans)

    async def process_async(
        self,
        question: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
        mode: str | None = None,
    ) -> str:
        all_spans, citation_count = self._get_template_inputs(display_spans, citation_spans)
        resolved = self.resolve_mode(mode)
        strategy = self.strategies[resolved]
        if resolved == "contextual" and hasattr(strategy, "generate_async"):
            template = await strategy.generate_async(question, all_spans, citation_count)
        else:
            template = strategy.generate(question, all_spans, citation_count)
        return strategy.fill(template, display_spans, citation_spans)

    @staticmethod
    def _get_template_inputs(
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> tuple[list[str], int]:
        """Linked citations are rendered inline, so only display spans shape
        the template and the flat citation block is suppressed."""
        if any(span.get("citation_ids") for span in display_spans):
            return [span["text"] for span in display_spans], 0
        return (
            [span["text"] for span in display_spans + citation_spans],
            len(citation_spans),
        )

    def get_template(
        self, question: str = "", spans: list[str] | None = None, citation_count: int = 0
    ) -> str:
        return self.strategy.generate(question, spans or [], citation_count)

    def fill_template(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        return self.strategy.fill(template, display_spans, citation_spans)

    # -- persistence ----------------------------------------------------------------

    def save(self, filepath: str) -> None:
        data = {
            "current_mode": self.current_mode,
            "strategies": {
                mode: strategy.save_state()
                for mode, strategy in self.strategies.items()
                if strategy is not None
            },
        }
        directory = os.path.dirname(filepath)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with open(filepath, "w") as f:
            json.dump(data, f, indent=2)

    def load(self, filepath: str) -> bool:
        if not os.path.exists(filepath):
            logger.warning("Template config file not found: %s", filepath)
            return False
        try:
            with open(filepath) as f:
                data = json.load(f)
        except Exception as exc:
            logger.warning("Failed to load template config: %s", exc)
            return False

        mode = data.get("current_mode")
        if mode and self.strategies.get(mode) is not None:
            self.current_mode = mode
        for name, state in data.get("strategies", {}).items():
            strategy = self.strategies.get(name)
            if strategy is None:
                continue
            try:
                strategy.load_state(state)
            except Exception as exc:
                logger.warning("Failed to load state for %s strategy: %s", name, exc)
        return True

    # -- convenience mode setters ---------------------------------------------------

    def use_static_mode(self, template: str | None = None) -> None:
        if template is not None:
            self.strategies["static"].set_template(template)
        self.set_mode("static")

    def use_contextual_mode(self) -> bool:
        return self.set_mode("contextual")

    def use_random_mode(self, templates: list[str] | None = None) -> None:
        if templates:
            strategy = self.strategies["random"]
            strategy.templates = []
            for t in templates:
                strategy.add_template(t)
        self.set_mode("random")

    def use_question_specific_mode(
        self, template_question_pairs: list[tuple[str, list[str]]] | None = None
    ) -> None:
        if template_question_pairs:
            strategy = self.strategies["question_specific"]
            strategy.clear()
            for template, questions in template_question_pairs:
                strategy.add_template(template, questions)
        self.set_mode("question_specific")

    def use_structured_mode(
        self,
        template: str,
        placeholder_mappings: dict[str, str] | None = None,
    ) -> None:
        strategy = self.strategies["structured"]
        strategy.set_template(template)
        for name, hint in (placeholder_mappings or {}).items():
            strategy.add_placeholder_mapping(name, hint)
        self.set_mode("structured")

    # -- citation propagation -----------------------------------------------------

    def set_citation_mode(self, citation_mode: str) -> None:
        self.citation_mode = citation_mode
        for strategy in self.strategies.values():
            if strategy is not None and hasattr(strategy, "set_citation_mode"):
                strategy.set_citation_mode(citation_mode)

    def set_citation_format(self, citation_format: str) -> None:
        self.citation_format = citation_format
        for strategy in self.strategies.values():
            if strategy is not None and hasattr(strategy, "filler"):
                strategy.filler.citation_format = citation_format

    def info(self) -> dict[str, Any]:
        return {
            "current_mode": self.current_mode,
            "available_modes": self.get_available_modes(),
            "has_llm_client": self.llm_client is not None,
            "citation_mode": self.citation_mode,
        }
