"""Template-driven structured extraction strategy.

Parity: reference `verbatim_core/templates/structured.py` — the template's
semantic placeholders (``[METHODOLOGY]``, ``[RESULTS]`` …) *drive* extraction:
each placeholder maps to an extraction hint, and `fill_with_spans` renders the
per-placeholder spans with globally consistent citation numbering (numbers
assigned in template order across all placeholders).
"""

from __future__ import annotations

import re
from typing import Any

from .base import TemplateStrategy
from .filler import SpanData

PLACEHOLDER_PATTERN = re.compile(r"\[([A-Z][A-Z0-9_]+)\]")
SYSTEM_PLACEHOLDERS = {"DISPLAY_SPANS", "RELEVANT_SENTENCES", "CITATION_REFS"}

STANDARD_MAPPINGS: dict[str, str] = {
    "METHODOLOGY": "methodology or methods used",
    "METHOD": "method used",
    "APPROACH": "approach taken",
    "RESULTS": "results or findings",
    "FINDINGS": "findings",
    "CONCLUSION": "conclusion",
    "CONTRIBUTIONS": "main contributions",
    "LIMITATIONS": "limitations",
    "FUTURE_WORK": "future work suggested",
    "BACKGROUND": "background information",
    "DATASET": "dataset used",
    "METRICS": "metrics used",
    "ACCURACY": "accuracy achieved",
    "PERFORMANCE": "performance results",
    "BASELINE": "baseline used",
    "RELATED_WORK": "related work discussed",
    "IMPLEMENTATION": "implementation details",
    "EVALUATION": "evaluation approach",
}


def _is_semantic(name: str) -> bool:
    return not name.startswith(("FACT_", "SPAN_")) and name not in SYSTEM_PLACEHOLDERS


class StructuredTemplate(TemplateStrategy):
    """Extraction guided by named placeholders in a user template."""

    PLACEHOLDER_PATTERN = PLACEHOLDER_PATTERN
    SYSTEM_PLACEHOLDERS = SYSTEM_PLACEHOLDERS
    STANDARD_MAPPINGS = STANDARD_MAPPINGS

    def __init__(
        self,
        rag_system=None,
        template: str | None = None,
        placeholder_mappings: dict[str, str] | None = None,
        citation_mode: str = "inline",
    ):
        self.rag_system = rag_system
        self.template = template
        self.custom_mappings = dict(placeholder_mappings or {})
        self.citation_mode = citation_mode

    # -- configuration -----------------------------------------------------------

    def set_rag_system(self, rag_system) -> None:
        self.rag_system = rag_system

    def set_template(self, template: str) -> None:
        self.validate_template(template)
        self.template = template

    def validate_template(self, template: str) -> None:
        if not template or not template.strip():
            raise ValueError("Template cannot be empty")
        has_semantic = any(
            _is_semantic(m.group(1)) for m in PLACEHOLDER_PATTERN.finditer(template)
        )
        has_standard = any(
            p in template
            for p in ("[DISPLAY_SPANS]", "[RELEVANT_SENTENCES]", "[SPAN_1]", "[FACT_1]")
        )
        if not (has_semantic or has_standard):
            raise ValueError(
                "Structured templates must contain semantic placeholders like "
                "[METHODOLOGY] or standard placeholders such as [DISPLAY_SPANS]"
            )

    def add_placeholder_mapping(self, placeholder: str, hint: str) -> None:
        self.custom_mappings[placeholder] = hint

    def get_placeholder_mappings(self) -> dict[str, str]:
        return {**STANDARD_MAPPINGS, **self.custom_mappings}

    def get_placeholder_hints(self) -> dict[str, str]:
        """Hints for every semantic placeholder present in the template."""
        if not self.template:
            return {}
        mappings = self.get_placeholder_mappings()
        hints: dict[str, str] = {}
        for m in PLACEHOLDER_PATTERN.finditer(self.template):
            name = m.group(1)
            if _is_semantic(name):
                hints[name] = mappings.get(name, name.replace("_", " ").lower())
        return hints

    def set_citation_mode(self, citation_mode: str) -> None:
        self.citation_mode = citation_mode

    # -- strategy interface ----------------------------------------------------

    def generate(self, question: str, spans: list[str], citation_count: int = 0) -> str:
        if not self.template:
            raise ValueError("Structured template not set")
        return self.template

    def fill(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        # Standard fill is a no-op: structured mode fills via fill_with_spans.
        return template

    def save_state(self) -> dict[str, Any]:
        return {
            "type": "structured",
            "template": self.template,
            "placeholder_mappings": self.custom_mappings,
            "citation_mode": self.citation_mode,
        }

    def load_state(self, state: dict[str, Any]) -> None:
        self.template = state.get("template", self.template)
        self.custom_mappings = dict(state.get("placeholder_mappings", {}))
        if "citation_mode" in state:
            self.citation_mode = state["citation_mode"]

    # -- structured fill ----------------------------------------------------------

    def fill_with_spans(self, span_map: dict[str, list]) -> str:
        """Replace each semantic placeholder with its spans.

        Citation numbers are assigned globally, walking the placeholders in
        template order, so the numbering is consistent across sections.
        """
        if not self.template:
            raise ValueError("Template not set")

        matches = [m for m in PLACEHOLDER_PATTERN.finditer(self.template) if _is_semantic(m.group(1))]

        # Forward pass: allocate citation numbers in reading order.
        next_number = 1
        allocation: dict[str, tuple[list[str], int]] = {}
        for m in matches:
            name = m.group(1)
            if name in allocation:
                continue
            texts = _texts_of(span_map.get(name, []))
            allocation[name] = (texts, next_number if texts else 0)
            next_number += len(texts)

        # Reverse pass: splice replacements without disturbing earlier offsets.
        result = self.template
        for m in reversed(matches):
            texts, start = allocation[m.group(1)]
            result = result[: m.start()] + self._render(texts, start) + result[m.end() :]
        return result

    def _render(self, texts: list[str], start_num: int) -> str:
        if not texts:
            return "(no relevant information found)"
        if self.citation_mode == "inline":
            return "\n\n".join(f"[{start_num + i}] {t}" for i, t in enumerate(texts))
        return "\n\n".join(texts)

    # -- async convenience (delegates to the RAG system) -------------------------

    async def fill_async(
        self,
        question: str,
        template: str | None = None,
        placeholder_mappings: dict[str, str] | None = None,
    ) -> str:
        if not self.rag_system:
            raise ValueError("RAG system not set")
        if template:
            self.set_template(template)
        for name, hint in (placeholder_mappings or {}).items():
            self.add_placeholder_mapping(name, hint)
        response = await self.rag_system.query_async(question)
        return response.answer


def _texts_of(items: list) -> list[str]:
    """Accept both bare-string and {text, doc} item shapes."""
    texts = []
    for item in items:
        if isinstance(item, str):
            text = item.strip()
        elif isinstance(item, dict):
            text = str(item.get("text", "")).strip()
        else:
            continue
        if text:
            texts.append(text)
    return texts
