"""Deterministic, LLM-free template strategy.

Parity: reference `verbatim_core/templates/static.py`. This is the strategy
the fully-offline TPU path uses: no network calls anywhere between question
and cited answer.
"""

from __future__ import annotations

from typing import Any

from .base import TemplateStrategy
from .filler import SpanData, TemplateFiller


class StaticTemplate(TemplateStrategy):
    """A fixed template; `generate` is a constant function."""

    DEFAULT_TEMPLATE = """## Response

The following is an unordered list of verbatim excerpts from the source documents. No synthesis or ranking is implied:

[DISPLAY_SPANS]

---
*These excerpts are taken verbatim from the source documents to ensure accuracy.*"""

    def __init__(
        self,
        template: str | None = None,
        citation_mode: str = "inline",
        citation_format: str = "[{number}]",
    ):
        self.template = template or self.DEFAULT_TEMPLATE
        self.citation_mode = citation_mode
        self.filler = TemplateFiller(citation_mode=citation_mode, citation_format=citation_format)
        self.validate_template(self.template)

    def generate(self, question: str, spans: list[str], citation_count: int = 0) -> str:
        return self.template

    def fill(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        return self.filler.fill(template, display_spans, citation_spans)

    def save_state(self) -> dict[str, Any]:
        return {"type": "static", "template": self.template}

    def load_state(self, state: dict[str, Any]) -> None:
        if "template" in state:
            self.set_template(state["template"])

    def set_template(self, template: str) -> None:
        self.validate_template(template)
        self.template = template

    def get_template(self) -> str:
        return self.template

    def set_citation_mode(self, citation_mode: str) -> None:
        self.citation_mode = citation_mode
        self.filler.set_citation_mode(citation_mode)

    def set_citation_format(self, citation_format: str) -> None:
        self.filler.citation_format = citation_format

    # -- factories -----------------------------------------------------------

    @classmethod
    def create_simple(cls, intro: str | None = None, outro: str | None = None) -> "StaticTemplate":
        intro = intro or "Verbatim excerpts from the source documents (unordered):"
        parts = [intro, "", "[DISPLAY_SPANS]"]
        if outro:
            parts += ["", outro]
        return cls("\n".join(parts))

    @classmethod
    def create_academic(cls) -> "StaticTemplate":
        return cls(
            "## Literature Review\n\n"
            "Based on the available literature:\n\n"
            "[DISPLAY_SPANS]\n\n"
            "### Summary\n\n"
            "These findings provide evidence relevant to the research question."
        )

    @classmethod
    def create_brief(cls) -> "StaticTemplate":
        return cls("**Key Points:**\n\n[DISPLAY_SPANS]")
