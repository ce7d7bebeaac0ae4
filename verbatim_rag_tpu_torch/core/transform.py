"""RAG-agnostic verbatim transform: context in, cited answer out.

Behavioral parity target: reference `verbatim_core/transform.py` — any
retrieval stack's context (dicts, objects with ``.text``, or plain strings)
can be re-answered verbatim without importing vector-store or index types.
The implementation here is structured around a normalization table and a
single shared pipeline body for the sync/async variants.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

from .extractors import LLMSpanExtractor, SpanExtractor
from .llm_client import LLMClient
from .models import QueryResponse
from .providers import RAGProvider
from .response_builder import ResponseBuilder
from .templates import TemplateManager


@dataclass
class ContextItem:
    """Normalized context entry — the duck-typed surface extractors need."""

    text: str
    metadata: dict[str, Any] = field(default_factory=dict)
    id: str = "ctx"
    score: float = 1.0


def normalize_context(context: Iterable[Any]) -> list[ContextItem]:
    """Coerce heterogeneous context items into :class:`ContextItem` views.

    Accepted shapes, in match order:
    - anything with a string ``.text`` attribute (SearchResult-likes);
    - mappings carrying ``content`` or ``text`` (title/source fold into
      metadata alongside any explicit ``metadata``);
    - bare strings.
    """
    normalized: list[ContextItem] = []
    for position, item in enumerate(context):
        normalized.append(_normalize_one(item, f"ctx_{position}"))
    return normalized


def _normalize_one(item: Any, rid: str) -> ContextItem:
    text_attr = getattr(item, "text", None)
    if isinstance(text_attr, str):
        return ContextItem(
            text=text_attr, metadata=dict(getattr(item, "metadata", None) or {}), id=rid
        )
    if isinstance(item, str):
        return ContextItem(text=item, id=rid)
    if isinstance(item, Mapping):
        body = item.get("content") or item.get("text")
        if not isinstance(body, str) or not body:
            raise ValueError("Context item missing 'content' (or 'text') string field.")
        meta: dict[str, Any] = {
            "title": item.get("title", ""),
            "source": item.get("source", ""),
        }
        meta.update(item.get("metadata") or {})
        return ContextItem(text=body, metadata=meta, id=rid)
    raise TypeError("Each context item must be a dict with 'content' (or 'text').")


class VerbatimTransform:
    """Apply verbatim extraction + templating to any retrieval context.

    All pipeline stages are injectable; defaults build the prompted-LLM
    extractor and a contextual template manager around one shared client.
    """

    def __init__(
        self,
        llm_client: LLMClient | None = None,
        extractor: SpanExtractor | None = None,
        template_manager: TemplateManager | None = None,
        max_display_spans: int = 5,
        extraction_mode: str = "auto",
        template_mode: str = "contextual",
        span_match_mode: str = "exact",
        fuzzy_threshold: float = 0.8,
        extraction_prompt: str | None = None,
        system_prompt: str | None = None,
    ):
        client = llm_client or LLMClient()
        self.llm_client = client
        self.extractor = extractor or LLMSpanExtractor(
            llm_client=client,
            extraction_mode=extraction_mode,
            max_display_spans=max_display_spans,
            span_match_mode=span_match_mode,
            fuzzy_threshold=fuzzy_threshold,
            extraction_prompt=extraction_prompt,
            system_prompt=system_prompt,
        )
        self.template_manager = template_manager or TemplateManager(
            llm_client=client, default_mode=template_mode
        )
        self.response_builder = ResponseBuilder()
        self.max_display_spans = max_display_spans

    # Both public variants share one pipeline body; only the two awaited
    # stages differ, so the async path passes pre-computed stage results in.

    def transform(
        self,
        question: str,
        context: Iterable[Any],
        answer: str | None = None,  # reserved; the verbatim answer is derived
    ) -> QueryResponse:
        items = normalize_context(context)
        spans_by_doc = self.extractor.extract_spans(question, items)
        display, citation = self._partition_spans(spans_by_doc)
        rendered = self.template_manager.process(question, display, citation)
        return self._finish(question, rendered, items, spans_by_doc, len(display))

    async def transform_async(
        self,
        question: str,
        context: Iterable[Any],
        answer: str | None = None,
    ) -> QueryResponse:
        items = normalize_context(context)
        spans_by_doc = await self.extractor.extract_spans_async(question, items)
        display, citation = self._partition_spans(spans_by_doc)
        rendered = await self.template_manager.process_async(question, display, citation)
        return self._finish(question, rendered, items, spans_by_doc, len(display))

    def _partition_spans(
        self, spans_by_doc: Mapping[str, list[str]]
    ) -> tuple[list[dict], list[dict]]:
        """Flatten in extractor order; the first ``max_display_spans`` render
        in the answer body, the rest become reference-only citations."""
        ordered = [
            {"text": span, "doc_text": doc_text}
            for doc_text, spans in spans_by_doc.items()
            for span in spans
        ]
        cut = self.max_display_spans
        return ordered[:cut], ordered[cut:]

    def _finish(
        self,
        question: str,
        rendered: str,
        items: list[ContextItem],
        spans_by_doc: Mapping[str, list[str]],
        display_count: int,
    ) -> QueryResponse:
        return self.response_builder.build_response(
            question=question,
            answer=self.response_builder.clean_answer(rendered),
            search_results=items,
            relevant_spans=dict(spans_by_doc),
            display_span_count=display_count,
        )


def verbatim_query(
    provider: RAGProvider,
    question: str,
    k: int = 5,
    filter: str | None = None,
    answer: str | None = None,
) -> QueryResponse:
    """One-shot: retrieve through ``provider`` and answer verbatim."""
    context = provider.retrieve(question, k=k, filter=filter)
    return VerbatimTransform().transform(question=question, context=context, answer=answer)


async def verbatim_query_async(
    provider: RAGProvider,
    question: str,
    k: int = 5,
    filter: str | None = None,
    answer: str | None = None,
) -> QueryResponse:
    context = await provider.retrieve_async(question, k=k, filter=filter)
    return await VerbatimTransform().transform_async(
        question=question, context=context, answer=answer
    )
