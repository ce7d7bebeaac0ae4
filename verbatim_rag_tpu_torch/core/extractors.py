"""Span extractor contract.

Copy of the `SpanExtractor` ABC from `verbatim_rag_tpu/core/extractors.py`:
``extract_spans(question, results) -> {doc_text: [span, ...]}`` with a
to-thread async default. The neural extractor lives in
`verbatim_rag_tpu_torch.models.highlighter`; the prompted LLM extractor comes
with a later slice of the port.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import Any

SpanMap = dict[str, list[str]]


class SpanExtractor(ABC):
    """Find verbatim spans answering `question` inside each search result."""

    @abstractmethod
    def extract_spans(self, question: str, search_results: list[Any]) -> SpanMap:
        """:return: mapping from each result's original text to its spans."""

    async def extract_spans_async(self, question: str, search_results: list[Any]) -> SpanMap:
        """Default async implementation: push the sync path to a thread."""
        return await asyncio.to_thread(self.extract_spans, question, search_results)
