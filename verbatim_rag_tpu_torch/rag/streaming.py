"""StreamingRAG — staged async streaming of the query pipeline (port of
`verbatim_rag_tpu/rag/streaming.py`).

An async generator yielding NDJSON-able events: intent short-circuit,
``documents`` (no highlights yet), a ``progress`` event with extraction
``elapsed_ms``, ``highlights``, and the final ``answer`` with ``done: true``
and the per-stage ``timings``; per-stage error events; plus a sync
collector. The per-call k is passed through without shared state. A stage
that launches kernels ends by synchronizing the index's device (in a worker
thread, so the event loop never waits on the card), and its host-clock time
runs to the kernels' end, not to their launch. With a reranker, a ``rerank``
stage follows retrieval; if it raises, the retrieval order stays.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator, Mapping

from verbatim_rag_tpu_torch.core.models import DocumentWithHighlights
from verbatim_rag_tpu_torch.utils.profiling import StageTimer, synchronize

from .core import VerbatimRAG

logger = logging.getLogger(__name__)


class StreamingRAG:
    def __init__(self, rag: VerbatimRAG):
        self.rag = rag

    async def stream_query(
        self,
        question: str,
        k: int | None = None,
        filter: Any = None,
        hybrid_weights: Mapping[str, float] | None = None,
        rrf_k: int = 60,
        search_params: Mapping[str, Any] | None = None,
        search_type: str | None = None,
        template_mode: str | None = None,
    ) -> AsyncIterator[dict[str, Any]]:
        rag = self.rag
        device = getattr(rag.index, "device", None)
        timer = StageTimer()

        # Stage 0: intent.
        if rag.intent_detector is not None:
            try:
                decision = await rag.intent_detector.detect_async(question)
            except Exception as exc:
                logger.warning("Intent detection failed: %s", exc)
                decision = None
            if decision is not None and decision.route != "continue":
                response = rag._short_circuit_response(question, decision)
                yield {"type": "answer", "data": response.model_dump(), "done": True}
                return

        # Stage 1: retrieval (+rerank) → documents without highlights.
        try:
            with timer.stage("retrieve"):
                results = await asyncio.to_thread(
                    rag.index.query, question, k or rag.k, filter, search_type,
                    hybrid_weights, rrf_k, search_params,
                )
                await asyncio.to_thread(synchronize, device)
            if rag.reranker is not None:
                try:
                    with timer.stage("rerank"):
                        results = await rag.reranker.rerank_async(question, results)
                        await asyncio.to_thread(synchronize, device)
                except Exception as exc:
                    logger.warning("Reranker failed; keeping order: %s", exc)
        except Exception as exc:
            logger.error("Retrieval failed: %s", exc)
            yield {"type": "error", "stage": "retrieval", "message": str(exc)}
            return

        documents = [
            DocumentWithHighlights(
                content=getattr(r, "text", "") or " ",
                highlights=[],
                title=(getattr(r, "metadata", {}) or {}).get("title", ""),
                source=(getattr(r, "metadata", {}) or {}).get("source", ""),
                metadata=getattr(r, "metadata", {}) or {},
            )
            for r in results
        ]
        yield {"type": "documents", "data": {"documents": [d.model_dump() for d in documents]}}

        # Stage 2: extraction (threaded) → highlights.
        try:
            started = time.time()
            with timer.stage("extract"):
                relevant_spans = await rag.extractor.extract_spans_async(question, results)
                await asyncio.to_thread(synchronize, device)
            elapsed_ms = int((time.time() - started) * 1000)
            yield {
                "type": "progress",
                "stage": "extraction_complete",
                "elapsed_ms": elapsed_ms,
            }
        except Exception as exc:
            logger.error("Extraction failed: %s", exc)
            yield {"type": "error", "stage": "extraction", "message": str(exc)}
            return

        docs_with_highlights = []
        with timer.stage("highlight"):
            for result in results:
                content = getattr(result, "text", "")
                spans = relevant_spans.get(content, [])
                highlights = (
                    rag.response_builder._create_highlights(content, spans) if spans else []
                )
                metadata = getattr(result, "metadata", {}) or {}
                docs_with_highlights.append(
                    DocumentWithHighlights(
                        content=content or " ",
                        highlights=highlights,
                        title=metadata.get("title", ""),
                        source=metadata.get("source", ""),
                        metadata=metadata,
                    )
                )
        yield {
            "type": "highlights",
            "data": {"documents": [d.model_dump() for d in docs_with_highlights]},
        }

        # Stage 3: template → final answer.
        try:
            with timer.stage("template"):
                display, citation = rag._rank_and_split_spans(relevant_spans)
                answer = await rag.template_manager.process_async(
                    question, display, citation, mode=template_mode
                )
                answer = rag.response_builder.clean_answer(answer)
                response = rag.response_builder.build_response(
                    question=question,
                    answer=answer,
                    search_results=results,
                    relevant_spans=relevant_spans,
                    display_span_count=len(display),
                )
        except Exception as exc:
            logger.error("Templating failed: %s", exc)
            yield {"type": "error", "stage": "template", "message": str(exc)}
            return
        # Per-stage breakdown (SURVEY.md §5 tracing plan): riding the final
        # event keeps the NDJSON protocol shape unchanged for old clients.
        yield {
            "type": "answer",
            "data": response.model_dump(),
            "done": True,
            "timings": timer.stages,
        }

    def stream_query_sync(self, question: str, **kwargs) -> list[dict[str, Any]]:
        """Collect all streaming events synchronously (test/CLI helper)."""

        async def collect():
            return [event async for event in self.stream_query(question, **kwargs)]

        return asyncio.run(collect())
