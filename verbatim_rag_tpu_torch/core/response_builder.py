"""Assemble the final QueryResponse: highlights, citations, cleaned answer.

Parity: reference `verbatim_core/response_builder.py` — highlights are found
by exact substring scan over the *original* chunk text with overlap
suppression; citations are numbered in document order and typed
display/reference by position.
"""

from __future__ import annotations

import re
from typing import Any

from .models import (
    Citation,
    DocumentWithHighlights,
    Highlight,
    QueryResponse,
    StructuredAnswer,
)

_MULTISPACE_RE = re.compile(r" {2,}")
_MULTINEWLINE_RE = re.compile(r"\n{3,}")


class ResponseBuilder:
    """Turn (search results, extracted spans, answer text) into a QueryResponse."""

    def build_response(
        self,
        question: str,
        answer: str,
        search_results: list[Any],
        relevant_spans: dict[str, list[str]],
        display_span_count: int | None = None,
    ) -> QueryResponse:
        documents: list[DocumentWithHighlights] = []
        citations: list[Citation] = []
        next_number = 1

        for doc_index, result in enumerate(search_results):
            content = getattr(result, "text", "")
            spans = relevant_spans.get(content, [])
            highlights = self._create_highlights(content, spans) if spans else []

            for highlight_index, highlight in enumerate(highlights):
                is_display = display_span_count is None or next_number <= display_span_count
                citations.append(
                    Citation(
                        text=highlight.text,
                        doc_index=doc_index,
                        highlight_index=highlight_index,
                        number=next_number,
                        type="display" if is_display else "reference",
                    )
                )
                next_number += 1

            metadata = getattr(result, "metadata", {}) or {}
            documents.append(
                DocumentWithHighlights(
                    # min_length=1 on the model: an empty-text result must
                    # degrade like the streaming path (" "), not 500 the
                    # whole response with a ValidationError.
                    content=content or " ",
                    highlights=highlights,
                    title=getattr(result, "title", "") or metadata.get("title", ""),
                    source=getattr(result, "source", "") or metadata.get("source", ""),
                    metadata=metadata,
                )
            )

        return QueryResponse(
            question=question,
            answer=answer,
            structured_answer=StructuredAnswer(text=answer, citations=citations),
            documents=documents,
        )

    def _create_highlights(self, doc_content: str, spans: list[str]) -> list[Highlight]:
        """Locate every non-overlapping occurrence of each span.

        Earlier spans win: once a region is claimed, later overlapping
        occurrences are skipped. Offsets index the original text — this is the
        provenance contract the UI renders from.
        """
        highlights: list[Highlight] = []
        claimed: list[tuple[int, int]] = []

        for span in spans:
            cursor = 0
            while True:
                start = doc_content.find(span, cursor)
                if start == -1:
                    break
                end = start + len(span)
                if not self._has_overlap(start, end, claimed):
                    highlights.append(Highlight(text=span, start=start, end=end))
                    claimed.append((start, end))
                cursor = end
        return highlights

    @staticmethod
    def _has_overlap(start: int, end: int, regions: list[tuple[int, int]]) -> bool:
        return any(start < r_end and end > r_start for r_start, r_end in regions)

    def clean_answer(self, answer: str) -> str:
        """Strip generation artifacts: wrapping quotes, literal ``\\n``,
        runs of spaces, and >2 consecutive newlines."""
        if not answer:
            return ""
        if len(answer) >= 2 and answer[0] == answer[-1] and answer[0] in {'"', "'"}:
            answer = answer[1:-1]
        answer = answer.replace("\\n", "\n")
        answer = _MULTISPACE_RE.sub(" ", answer)
        answer = _MULTINEWLINE_RE.sub("\n\n", answer)
        return answer.strip()
