"""VerbatimRAG — the end-to-end orchestrator (port of
`verbatim_rag_tpu/rag/core.py`).

question → (intent short-circuit) → retrieve (`VerbatimIndex.query`) →
(rerank) → extract verbatim spans → rank and split spans → template → clean
→ cited `QueryResponse`. The extractor defaults to `ModelSpanExtractor` on the
index's device with no LLM client, and to the prompted `LLMSpanExtractor`
with one (then the template mode defaults to ``contextual``). Structured
template mode lets the LLM extract per placeholder, and every span is
verified against its attributed document. :meth:`VerbatimRAG.query_batch`
serves many questions with one retrieval dispatch and one extractor pass
(`extract_spans_multi`), :meth:`VerbatimRAG.query_async` is the async
mirror of :meth:`VerbatimRAG.query`, and :meth:`VerbatimRAG.warmup` runs one
query at serving start-up. A ``reranker`` (`rag.rerankers`) reorders each
question's results before extraction; if it raises, the retrieval order
stays and a warning is logged.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Mapping

from verbatim_rag_tpu_torch.core.extractors import SpanExtractor
from verbatim_rag_tpu_torch.core.models import QueryResponse, StructuredAnswer
from verbatim_rag_tpu_torch.core.response_builder import ResponseBuilder
from verbatim_rag_tpu_torch.core.templates import TemplateManager
from verbatim_rag_tpu_torch.utils import profiling


logger = logging.getLogger(__name__)


class VerbatimRAG:
    """question → retrieve → (rerank) → extract → template → cited answer."""

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
        self.index = index
        self.llm_client = llm_client
        self.k = k
        self.max_display_spans = max_display_spans

        if extractor is not None:
            self.extractor = extractor
        elif llm_client is not None:
            from verbatim_rag_tpu_torch.core.extractors import LLMSpanExtractor

            self.extractor = LLMSpanExtractor(llm_client=llm_client)
        else:
            from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor

            self.extractor = ModelSpanExtractor(device=getattr(index, "device", None))

        default_mode = template_mode or ("contextual" if llm_client else "static")
        self.template_manager = template_manager or TemplateManager(
            llm_client=llm_client, default_mode=default_mode
        )
        self.response_builder = response_builder or ResponseBuilder()
        self.intent_detector = intent_detector
        self.reranker = reranker
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
        decision = self._detect_intent(question)
        if decision is not None and decision.route != "continue":
            return self._short_circuit_response(question, decision)

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

        if self.template_manager.resolve_mode(template_mode) == "structured":
            return self._query_structured(question, results)

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
        if self.intent_detector is not None:
            try:
                decision = await self.intent_detector.detect_async(question)
            except Exception as exc:
                logger.warning("Intent detection failed: %s", exc)
                decision = None
            if decision is not None and decision.route != "continue":
                return self._short_circuit_response(question, decision)

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
        if self.reranker is not None:
            try:
                results = await self.reranker.rerank_async(question, results)
            except Exception as exc:
                logger.warning("Reranker failed; keeping retrieval order: %s", exc)

        if self.template_manager.resolve_mode(template_mode) == "structured":
            return await asyncio.to_thread(self._query_structured, question, results)

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
        :meth:`query`'s for its question: intent short-circuits apply and keep
        their positions, and structured template mode (its extraction is
        template-driven, not batchable) falls back to per-question queries.

        While a profiler records, the call is the root span
        ``rag.query_batch`` (templates and responses: ``rag.respond``) and
        counts ``rag.questions``.
        """
        profiling.count("rag.questions", len(questions))
        with profiling.span("rag.query_batch"):
            if self.template_manager.resolve_mode(template_mode) == "structured":
                return [
                    self.query(
                        q, k=k, filter=filter, hybrid_weights=hybrid_weights,
                        rrf_k=rrf_k, search_params=search_params,
                        search_type=search_type, template_mode=template_mode,
                    )
                    for q in questions
                ]

            short_circuits: dict[int, QueryResponse] = {}
            if self.intent_detector is not None:
                for i, q in enumerate(questions):
                    decision = self._detect_intent(q)
                    if decision is not None and decision.route != "continue":
                        short_circuits[i] = self._short_circuit_response(q, decision)
            live = [i for i in range(len(questions)) if i not in short_circuits]
            if not live:
                return [short_circuits[i] for i in range(len(questions))]
            questions = [questions[i] for i in live]

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
            with profiling.span("rag.respond"):
                responses = [
                    self._respond(question, results, relevant_spans, template_mode)
                    for question, results, relevant_spans in zip(questions, reranked, spans_per_q)
                ]
            if not short_circuits:
                return responses
            # Re-interleave intent short-circuits at their original positions.
            merged, live_iter = [], iter(responses)
            for i in range(len(short_circuits) + len(responses)):
                merged.append(short_circuits[i] if i in short_circuits else next(live_iter))
            return merged

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

    def _detect_intent(self, question: str):
        if self.intent_detector is None:
            return None
        try:
            return self.intent_detector.detect(question)
        except Exception as exc:
            logger.warning("Intent detection failed: %s", exc)
            return None

    def _short_circuit_response(self, question: str, decision) -> QueryResponse:
        answer = decision.answer or "I can't help with that request."
        return QueryResponse(
            question=question,
            answer=answer,
            structured_answer=StructuredAnswer(text=answer, citations=[]),
            documents=[],
        )

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
        if self.reranker is None or not results:
            return results
        try:
            return self.reranker.rerank(question, results)
        except Exception as exc:
            logger.warning("Reranker failed; keeping retrieval order: %s", exc)
            return results

    def _query_structured(self, question: str, results: list[Any]) -> QueryResponse:
        """Template-driven extraction: the structured template's placeholders
        decide what gets extracted, and each span is verified against the
        document it is attributed to (provenance)."""
        if self.llm_client is None:
            raise ValueError("Structured mode requires an LLM client")
        from verbatim_rag_tpu_torch.core.span_verify import verify_spans

        strategy = self.template_manager.strategies["structured"]
        hints = strategy.get_placeholder_hints()
        doc_texts = [getattr(r, "text", "") for r in results]
        span_map = self.llm_client.extract_structured(
            question, strategy.template, hints, doc_texts
        )

        verified_map: dict[str, list[dict]] = {}
        relevant_spans: dict[str, list[str]] = {t: [] for t in doc_texts}
        for name, items in span_map.items():
            kept = []
            for item in items:
                doc_idx = int(item.get("doc", 0))
                if not 0 <= doc_idx < len(doc_texts):
                    continue
                ok = verify_spans([item.get("text", "")], doc_texts[doc_idx])
                if ok:
                    kept.append({"text": ok[0], "doc": doc_idx})
                    relevant_spans[doc_texts[doc_idx]].append(ok[0])
            verified_map[name] = kept

        answer = strategy.fill_with_spans(verified_map)
        answer = self.response_builder.clean_answer(answer)
        return self.response_builder.build_response(
            question=question,
            answer=answer,
            search_results=results,
            relevant_spans=relevant_spans,
        )

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
