"""Placeholder engine that renders verbatim spans into a template.

Behavioral parity target: reference `verbatim_core/templates/filler.py` —
aggregate placeholders (``[DISPLAY_SPANS]`` / ``[RELEVANT_SENTENCES]``),
per-fact placeholders (``[SPAN_N]`` / ``[FACT_N]``), a flat reference block
(``[CITATION_REFS]``), linked citations (a display span carrying
``citation_ids`` gets its source markers appended inline, and the flat
reference block is suppressed), inline vs hidden citation modes, a
configurable marker format, and markdown-table-aware marker placement.

This module is pure string work and intentionally device-free: span *content*
always comes from the document (provenance contract); the filler only arranges
it.
"""

from __future__ import annotations

import re
from typing import Any

SpanData = dict[str, Any]

_FACT_RE = re.compile(r"\[(?:SPAN|FACT)_(\d+)\]")
_CITATION_REFS = "[CITATION_REFS]"
_NO_INFO = "No relevant information found in the provided documents."

#: Placeholders any valid template must contain at least one of.
ACCEPTED_PLACEHOLDERS = (
    "[RELEVANT_SENTENCES]",
    "[DISPLAY_SPANS]",
    "[SPAN_1]",
    "[FACT_1]",
)


class TemplateFiller:
    """Substitute extracted spans into a template's placeholders."""

    ALLOWED_MODES = {"inline", "hidden"}

    def __init__(self, citation_mode: str = "inline", citation_format: str = "[{number}]"):
        """
        :param citation_mode: "inline" embeds numbered markers next to each
            span; "hidden" renders clean text without markers.
        :param citation_format: ``str.format`` template for markers. Variables:
            ``{number}`` (sequential integer) and ``{span_id}`` (the span's own
            id, falling back to ``str(number)``).
        """
        self.set_citation_mode(citation_mode)
        self.citation_format = citation_format

    # -- configuration -----------------------------------------------------

    def set_citation_mode(self, citation_mode: str) -> None:
        if citation_mode not in self.ALLOWED_MODES:
            raise ValueError(
                f"Unsupported citation mode: {citation_mode!r}; "
                f"allowed: {sorted(self.ALLOWED_MODES)}"
            )
        self.citation_mode = citation_mode

    # -- main entry ---------------------------------------------------------

    def fill(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        if not template:
            return ""

        numbering = _CitationNumbering(display_spans, citation_spans)
        linked = any(s.get("citation_ids") for s in display_spans)

        flat_refs = ""
        if citation_spans and self.citation_mode == "inline" and not linked:
            flat_refs = " ".join(
                self._marker(numbering.first_citation_number + i, span)
                for i, span in enumerate(citation_spans)
            )

        if _FACT_RE.search(template):
            out = self._fill_per_fact(template, display_spans, citation_spans, numbering)
        else:
            out = self._fill_aggregate(template, display_spans, numbering)

        if _CITATION_REFS in out:
            out = out.replace(_CITATION_REFS, flat_refs)
        return out.strip()

    # -- per-fact path ------------------------------------------------------

    def _fill_per_fact(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
        numbering: "_CitationNumbering",
    ) -> str:
        spans = display_spans + citation_spans

        def substitute(m: re.Match) -> str:
            n = int(m.group(1))
            if not 1 <= n <= len(spans):
                return ""
            if n <= len(display_spans):
                return self._render_span(display_spans[n - 1], n, numbering)
            # Citation-only slots render as a bare marker (inline mode).
            return self._marker(n, spans[n - 1]) if self.citation_mode == "inline" else ""

        return _FACT_RE.sub(substitute, template)

    # -- aggregate path -----------------------------------------------------

    def _fill_aggregate(
        self,
        template: str,
        display_spans: list[SpanData],
        numbering: "_CitationNumbering",
    ) -> str:
        blocks = [
            b
            for i, span in enumerate(display_spans, start=1)
            if (b := self._render_span(span, i, numbering))
        ]
        body = "\n\n".join(blocks) if blocks else _NO_INFO
        return template.replace("[DISPLAY_SPANS]", body).replace("[RELEVANT_SENTENCES]", body)

    # -- span rendering -----------------------------------------------------

    def _render_span(self, span: SpanData, number: int, numbering: "_CitationNumbering") -> str:
        text = str(span.get("text", "")).strip()
        if not text:
            return ""
        if self.citation_mode != "inline":
            return text

        marker = self._marker(number, span)
        linked = self._linked_refs(span, numbering)
        if _looks_like_markdown_table(text):
            head = f"{marker} {linked}" if linked else marker
            return f"{head}\n\n{text}"
        return f"{marker} {text} {linked}" if linked else f"{marker} {text}"

    def _linked_refs(self, span: SpanData, numbering: "_CitationNumbering") -> str:
        """Markers for the citation spans this display span is linked to."""
        parts = []
        for cid in span.get("citation_ids", []) or []:
            resolved = numbering.resolve(str(cid))
            if resolved is not None:
                num, sid = resolved
                parts.append(self.citation_format.format(number=num, span_id=sid))
        return " ".join(parts)

    def _marker(self, number: int, span: SpanData) -> str:
        span_id = span.get("span_id", str(number))
        return self.citation_format.format(number=number, span_id=span_id)

    # -- static helpers -----------------------------------------------------

    @staticmethod
    def _is_table(text: str) -> bool:
        return _looks_like_markdown_table(text)

    @staticmethod
    def ensure_placeholder(template: str, placeholder: str = "[DISPLAY_SPANS]") -> str:
        """Append a placeholder when the template carries none at all."""
        if any(p in template for p in ACCEPTED_PLACEHOLDERS):
            return template
        return f"{template}\n\n{placeholder}"


class _CitationNumbering:
    """Sequential numbering of spans: display first, then citation spans.

    Citation spans numbered ``len(display)+1 ...`` can also be addressed by a
    ``citation_id`` key, which is how linked citations resolve back to a
    marker number / span_id pair.
    """

    def __init__(self, display_spans: list[SpanData], citation_spans: list[SpanData]):
        self.first_citation_number = len(display_spans) + 1
        self._by_citation_id: dict[str, tuple[int, str]] = {}
        for offset, span in enumerate(citation_spans):
            cid = span.get("citation_id")
            if cid:
                number = self.first_citation_number + offset
                span_id = span.get("span_id", str(number))
                self._by_citation_id[str(cid)] = (number, str(span_id))

    def resolve(self, citation_id: str) -> tuple[int, str] | None:
        return self._by_citation_id.get(citation_id)


def _looks_like_markdown_table(text: str) -> bool:
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    if len(lines) < 2:
        return False
    piped = sum(1 for ln in lines if "|" in ln)
    return piped >= 2 and piped >= len(lines) / 2
