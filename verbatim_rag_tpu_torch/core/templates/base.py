"""Template strategy contract.

Parity: reference `verbatim_core/templates/base.py` — every strategy can
generate a placeholder template for a (question, spans) pair, fill it with
verbatim span content, and round-trip its configuration as a JSON-able dict.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

from .filler import ACCEPTED_PLACEHOLDERS, SpanData


class TemplateStrategy(ABC):
    """Generate + fill + persist: the three capabilities of a template mode."""

    @abstractmethod
    def generate(self, question: str, spans: list[str], citation_count: int = 0) -> str:
        """Produce a template string containing placeholders."""

    @abstractmethod
    def fill(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        """Substitute the spans into the template's placeholders."""

    @abstractmethod
    def save_state(self) -> dict[str, Any]:
        """Serialize this strategy's configuration."""

    @abstractmethod
    def load_state(self, state: dict[str, Any]) -> None:
        """Restore configuration produced by :meth:`save_state`."""

    def validate_template(self, template: str) -> None:
        """Reject templates that could never surface a verbatim span."""
        if not template or not template.strip():
            raise ValueError("Template cannot be empty")
        if not any(p in template for p in ACCEPTED_PLACEHOLDERS):
            raise ValueError(
                "Template must contain at least one of: "
                "[RELEVANT_SENTENCES], [DISPLAY_SPANS], or [SPAN_1]"
            )
