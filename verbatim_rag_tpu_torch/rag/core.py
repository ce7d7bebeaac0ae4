"""VerbatimRAG — the end-to-end orchestrator (port of
`verbatim_rag_tpu/rag/core.py`, the synchronous offline path).

question → retrieve (`VerbatimIndex.query`) → extract verbatim spans
(`ModelSpanExtractor` by default, on the index's device) → rank and split
spans → template → clean → cited `QueryResponse`.

Not ported yet: LLM clients, intent detectors, rerankers, structured
template mode and the async mirror; passing one raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Mapping

from verbatim_rag_tpu_torch.core.extractors import SpanExtractor
from verbatim_rag_tpu_torch.core.models import QueryResponse
from verbatim_rag_tpu_torch.core.response_builder import ResponseBuilder
from verbatim_rag_tpu_torch.core.templates import TemplateManager


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet")


class VerbatimRAG:
    """question → retrieve → extract → template → cited answer."""

    def __init__(
        self,
        index,
        llm_client=None,
        extractor: SpanExtractor | None = None,
        template_manager: TemplateManager | None = None,
        response_builder: ResponseBuilder | None = None,
        intent_detector=None,
        reranker=None,
        k: int = 5,
        max_display_spans: int = 5,
        template_mode: str | None = None,
    ):
        if llm_client is not None:
            raise _not_ported("An LLM client")
        if intent_detector is not None:
            raise _not_ported("Intent detection")
        if reranker is not None:
            raise _not_ported("Reranking")
        if template_mode == "structured":
            raise _not_ported("Structured template mode")
        self.index = index
        self.k = k
        self.max_display_spans = max_display_spans

        if extractor is not None:
            self.extractor = extractor
        else:
            from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor

            self.extractor = ModelSpanExtractor(device=getattr(index, "device", None))

        self.template_manager = template_manager or TemplateManager(
            llm_client=None, default_mode=template_mode or "static"
        )
        self.response_builder = response_builder or ResponseBuilder()
        self._wire_routing_embeddings()

    def _wire_routing_embeddings(self) -> None:
        """Route question-specific templates with the index's dense provider
        (only replaces the model-free hashed default)."""
        strategy = self.template_manager.strategies.get("question_specific")
        provider = getattr(self.index, "dense_provider", None)
        if (
            strategy is None
            or provider is None
            or not getattr(strategy, "uses_default_embed", False)
        ):
            return

        def embed(texts):
            import numpy as np

            return np.asarray(provider.embed_batch(list(texts)), dtype=float).tolist()

        strategy.set_embed_fn(embed)

    def query(
        self,
        question: str,
        k: int | None = None,
        filter: Any = None,
        hybrid_weights: Mapping[str, float] | None = None,
        rrf_k: int = 60,
        search_params: Mapping[str, Any] | None = None,
        search_type: str | None = None,
        template_mode: str | None = None,
    ) -> QueryResponse:
        if self.template_manager.resolve_mode(template_mode) == "structured":
            raise _not_ported("Structured template mode")
        results = self.index.query(
            question,
            k=k or self.k,
            filter=filter,
            search_type=search_type,
            hybrid_weights=hybrid_weights,
            rrf_k=rrf_k,
            search_params=search_params,
        )
        results = self._apply_reranker(question, results)

        relevant_spans = self.extractor.extract_spans(question, results)
        display, citation = self._rank_and_split_spans(relevant_spans)
        answer = self.template_manager.process(
            question, display, citation, mode=template_mode
        )
        answer = self.response_builder.clean_answer(answer)
        return self.response_builder.build_response(
            question=question,
            answer=answer,
            search_results=results,
            relevant_spans=relevant_spans,
            display_span_count=len(display),
        )

    # -- ingest passthrough ------------------------------------------------------------

    def add_document(self, doc) -> str:
        return self.index.add_document(doc)

    def add_documents(self, docs) -> list[str]:
        return self.index.add_documents(docs)

    # -- internals ----------------------------------------------------------------------

    def _apply_reranker(self, question: str, results: list[Any]) -> list[Any]:
        """Reranking hook: no reranker is ported yet (the constructor refuses
        one), so retrieval order stays."""
        return results

    def _rank_and_split_spans(
        self, relevant_spans: Mapping[str, list[str]]
    ) -> tuple[list[dict], list[dict]]:
        """Flatten spans preserving extractor order; head displays, tail cites."""
        flattened = [
            {"text": span, "doc_text": doc_text}
            for doc_text, spans in relevant_spans.items()
            for span in spans
        ]
        return flattened[: self.max_display_spans], flattened[self.max_display_spans :]
