"""VerbatimRAG — the end-to-end orchestrator (port of
`verbatim_rag_tpu/rag/core.py`, the offline path).

question → retrieve (`VerbatimIndex.query`) → extract verbatim spans
(`ModelSpanExtractor` by default, on the index's device) → rank and split
spans → template → clean → cited `QueryResponse`. :meth:`VerbatimRAG.query_batch`
serves many questions with one retrieval dispatch and one extractor pass
(`extract_spans_multi`), :meth:`VerbatimRAG.query_async` is the async
mirror of :meth:`VerbatimRAG.query`, and :meth:`VerbatimRAG.warmup` runs one
query at serving start-up.

Not ported yet: LLM clients, intent detectors, rerankers and structured
template mode; passing one raises ``NotImplementedError``, so the JAX
package's branches for them (intent short-circuits, reranking, the
structured fallback of the batched and async entries) are left out.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Mapping

from verbatim_rag_tpu_torch.core.extractors import SpanExtractor
from verbatim_rag_tpu_torch.core.models import QueryResponse
from verbatim_rag_tpu_torch.core.response_builder import ResponseBuilder
from verbatim_rag_tpu_torch.core.templates import TemplateManager


logger = logging.getLogger(__name__)


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
        self._refuse_structured(template_mode)
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
        return self._respond(question, results, relevant_spans, template_mode)

    # -- public async ---------------------------------------------------------------

    async def query_async(
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
        """:meth:`query` for an event loop: retrieval in a worker thread, then
        the extractor's and the template manager's async entries."""
        self._refuse_structured(template_mode)
        results = await asyncio.to_thread(
            self.index.query,
            question,
            k or self.k,
            filter,
            search_type,
            hybrid_weights,
            rrf_k,
            search_params,
        )
        relevant_spans = await self.extractor.extract_spans_async(question, results)
        display, citation = self._rank_and_split_spans(relevant_spans)
        answer = await self.template_manager.process_async(
            question, display, citation, mode=template_mode
        )
        return self._build(question, answer, results, relevant_spans, display)

    def query_batch(
        self,
        questions: list[str],
        k: int | None = None,
        filter: Any = None,
        hybrid_weights: Mapping[str, float] | None = None,
        rrf_k: int = 60,
        search_params: Mapping[str, Any] | None = None,
        search_type: str | None = None,
        template_mode: str | None = None,
    ) -> list[QueryResponse]:
        """Serve many questions with ONE batched retrieval dispatch
        (`VerbatimIndex.query_batch`) and, for an extractor that has
        ``extract_spans_multi``, one extractor pass over every question's
        results; templating then runs per question. Each response equals
        :meth:`query`'s for its question.
        """
        self._refuse_structured(template_mode)
        results_per_q = self.index.query_batch(
            list(questions),
            k=k or self.k,
            filter=filter,
            search_type=search_type,
            hybrid_weights=hybrid_weights,
            rrf_k=rrf_k,
            search_params=search_params,
        )
        reranked = [self._apply_reranker(q, r) for q, r in zip(questions, results_per_q)]
        if hasattr(self.extractor, "extract_spans_multi"):
            spans_per_q = self.extractor.extract_spans_multi(list(zip(questions, reranked)))
        else:
            spans_per_q = [
                self.extractor.extract_spans(q, r) for q, r in zip(questions, reranked)
            ]
        return [
            self._respond(question, results, relevant_spans, template_mode)
            for question, results, relevant_spans in zip(questions, reranked, spans_per_q)
        ]

    def warmup(self) -> None:
        """Run one query at serving start-up (kernel builds, library
        initialisation), so the first user request does not pay for them.
        An empty index skips it; a failing warm-up query is logged, not
        raised, as in the JAX package."""
        if self.index.inspect()["num_chunks"] == 0:
            logger.info("warmup skipped: empty index")
            return
        try:
            self.query("warmup query", k=1)
        except Exception as exc:
            logger.warning("warmup query failed: %s", exc)

    # -- ingest passthrough ------------------------------------------------------------

    def add_document(self, doc) -> str:
        return self.index.add_document(doc)

    def add_documents(self, docs) -> list[str]:
        return self.index.add_documents(docs)

    def add_documents_batch(self, docs, **kwargs) -> list[str]:
        return self.index.add_documents_bulk(docs, **kwargs)

    # -- internals ----------------------------------------------------------------------

    def _refuse_structured(self, template_mode: str | None) -> None:
        if self.template_manager.resolve_mode(template_mode) == "structured":
            raise _not_ported("Structured template mode")

    def _respond(self, question, results, relevant_spans, template_mode) -> QueryResponse:
        """Rank and split the spans, fill the template, build the response."""
        display, citation = self._rank_and_split_spans(relevant_spans)
        answer = self.template_manager.process(question, display, citation, mode=template_mode)
        return self._build(question, answer, results, relevant_spans, display)

    def _build(self, question, answer, results, relevant_spans, display) -> QueryResponse:
        return self.response_builder.build_response(
            question=question,
            answer=self.response_builder.clean_answer(answer),
            search_results=results,
            relevant_spans=relevant_spans,
            display_span_count=len(display),
        )

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
