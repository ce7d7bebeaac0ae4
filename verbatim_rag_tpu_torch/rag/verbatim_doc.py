"""VerbatimDOC — document generation with embedded retrieval queries.

Copy of `verbatim_rag_tpu/rag/verbatim_doc.py` (held to it by
`tests/test_torch_doc.py`): documents contain directives like
``[!query=what are the results|format=bullet,max_length=200]`` (regex parse
+ typed params); each query runs through the RAG system with the nearest
section header prepended as context; answers are spliced back in with
formatting options (bullet/short/max_length); the final response carries
**global citation numbering across all queries** with per-document dedup.
A document's directives run as batched queries (`Processor.run_batch`: one
`VerbatimRAG.query_batch` per distinct ``k``). Interactive and streaming
variants surface per-query progress/approval events.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable

logger = logging.getLogger(__name__)

_QUERY_RE = re.compile(r"\[!query=([^\]|]+)(?:\|([^\]]+))?\]")
_HEADER_RE = re.compile(r"^(#{1,6})\s+(.+)$", re.MULTILINE)


def _parse_params(raw: str | None) -> dict[str, Any]:
    """``format=bullet,max_length=200`` → typed dict."""
    params: dict[str, Any] = {}
    if not raw:
        return params
    for piece in raw.split(","):
        if "=" not in piece:
            continue
        key, value = piece.split("=", 1)
        key, value = key.strip(), value.strip()
        if value.isdigit():
            params[key] = int(value)
        elif value.lower() in ("true", "false"):
            params[key] = value.lower() == "true"
        else:
            params[key] = value
    return params


@dataclass
class DocQuery:
    text: str
    params: dict[str, Any]
    start: int
    end: int
    section: str = ""


@dataclass
class QueryResult:
    query: DocQuery
    spans: list[dict[str, Any]] = field(default_factory=list)  # {text, doc_title, doc_index}
    answer_text: str = ""
    error: str | None = None


class Parser:
    """Find query directives and their enclosing section headers."""

    @staticmethod
    def parse(document: str) -> list[DocQuery]:
        headers = [(m.start(), m.group(2).strip()) for m in _HEADER_RE.finditer(document)]
        queries = []
        for m in _QUERY_RE.finditer(document):
            section = ""
            for pos, title in headers:
                if pos < m.start():
                    section = title
                else:
                    break
            queries.append(
                DocQuery(
                    text=m.group(1).strip(),
                    params=_parse_params(m.group(2)),
                    start=m.start(),
                    end=m.end(),
                    section=section,
                )
            )
        return queries


class Processor:
    """Run one DocQuery through the RAG system and collect attributed spans."""

    def __init__(self, rag, k: int = 5):
        self.rag = rag  # duck-typed: needs .query(question, k=...) → QueryResponse
        self.k = k

    def run(self, query: DocQuery) -> QueryResult:
        question = self._question(query)
        try:
            response = self.rag.query(question, k=query.params.get("k", self.k))
        except Exception as exc:
            logger.error("VerbatimDOC query failed: %s", exc)
            return QueryResult(query=query, error=str(exc))
        return self._collect(query, response)

    def run_batch(self, queries: list[DocQuery]) -> list[QueryResult]:
        """Run a document's directives as BATCHED queries.

        A document with n embedded queries is the natural unit for the
        batched serving path: grouped by their per-directive ``k``,
        retrieval for each group is ONE device program and neural
        extraction one forward (`VerbatimRAG.query_batch`). Falls back to
        sequential `run` when the RAG object has no ``query_batch`` or a
        batch fails (per-group, preserving per-query error isolation).
        """
        if not hasattr(self.rag, "query_batch") or len(queries) <= 1:
            return [self.run(q) for q in queries]
        out: list[QueryResult | None] = [None] * len(queries)
        by_k: dict[int, list[int]] = {}
        for i, q in enumerate(queries):
            try:
                kk = int(q.params.get("k", self.k))
            except (TypeError, ValueError):
                # A malformed k directive must not take down the document —
                # route just this query through run(), whose try produces a
                # per-query error result (0.3.0 behavior).
                out[i] = self.run(q)
                continue
            by_k.setdefault(kk, []).append(i)
        for k, idxs in by_k.items():
            try:
                responses = list(
                    self.rag.query_batch(
                        [self._question(queries[i]) for i in idxs], k=k
                    )
                )
                if len(responses) != len(idxs):
                    raise ValueError(
                        f"query_batch returned {len(responses)} responses "
                        f"for {len(idxs)} questions"
                    )
                # Collect inside the try: a duck-typed rag whose query_batch
                # returns right-length garbage must also fall back.
                collected = [
                    self._collect(queries[i], r) for i, r in zip(idxs, responses)
                ]
            except Exception as exc:
                logger.error(
                    "VerbatimDOC batch of %d failed (%s); retrying sequentially",
                    len(idxs), exc,
                )
                for i in idxs:
                    out[i] = self.run(queries[i])
                continue
            for i, result in zip(idxs, collected):
                out[i] = result
        return [r for r in out if r is not None]

    def _question(self, query: DocQuery) -> str:
        if query.section:
            return f"{query.section}: {query.text}"  # section-context prefix
        return query.text

    def _collect(self, query: DocQuery, response) -> QueryResult:
        spans: list[dict[str, Any]] = []
        for doc_index, doc in enumerate(response.documents):
            for h in doc.highlights:
                spans.append(
                    {
                        "text": h.text,
                        "doc_title": doc.title or doc.source or f"document {doc_index}",
                        "doc_index": doc_index,
                    }
                )
        result = QueryResult(query=query, spans=spans)
        result.answer_text = _format_spans(spans, query.params)
        return result


def _format_spans(spans: list[dict[str, Any]], params: dict[str, Any]) -> str:
    """Render spans per the directive's format params."""
    if not spans:
        return "(no supporting material found)"
    max_length = params.get("max_length")
    fmt = params.get("format", "inline")

    texts = [s["text"] for s in spans]
    if fmt == "short":
        texts = texts[:1]
    # Tolerate malformed values the same way a malformed `k` is tolerated
    # (run_batch line ~120): a bad directive must degrade for ITS query, not
    # crash the whole document via an exception outside run()'s try.
    try:
        max_length = int(max_length) if max_length else None
    except (TypeError, ValueError):
        logger.warning("Ignoring malformed max_length directive: %r", max_length)
        max_length = None
    if max_length:
        budget = max_length
        kept: list[str] = []
        for t in texts:
            if budget <= 0:
                break
            kept.append(t if len(t) <= budget else t[:budget].rstrip() + "…")
            budget -= len(t)
        texts = kept

    if fmt == "bullet":
        return "\n" + "\n".join(f"- {t}" for t in texts)
    return " ".join(texts)


class Replacer:
    """Splice rendered answers (with citation markers) back into the document."""

    @staticmethod
    def apply(document: str, results: list[QueryResult], numbering: dict[int, int]) -> str:
        out = document
        for result in sorted(results, key=lambda r: -r.query.start):
            rendered = result.answer_text
            markers = " ".join(
                f"[{numbering[id(span)]}]" for span in result.spans if id(span) in numbering
            )
            if markers and rendered and "(no supporting" not in rendered:
                rendered = f"{rendered} {markers}"
            out = out[: result.query.start] + rendered + out[result.query.end :]
        return out


@dataclass
class VerbatimDocResponse:
    document: str
    queries: list[QueryResult]
    citations: list[dict[str, Any]]  # {number, text, doc_title}


class VerbatimDOC:
    """End-to-end: parse → process each query → splice with global citations."""

    def __init__(self, rag, k: int = 5):
        self.rag = rag
        self.processor = Processor(rag, k=k)

    def process(self, document: str) -> VerbatimDocResponse:
        queries = Parser.parse(document)
        results = self.processor.run_batch(queries)
        return self._build_response(document, results)

    def process_interactive(
        self, document: str, approve: Callable[[QueryResult], bool]
    ) -> VerbatimDocResponse:
        """Run queries one by one; ``approve`` can veto each result (vetoed
        directives are left in place)."""
        queries = Parser.parse(document)
        results = []
        for q in queries:
            result = self.processor.run(q)
            if approve(result):
                results.append(result)
        return self._build_response(document, results)

    async def stream_process(self, document: str) -> AsyncIterator[dict[str, Any]]:
        """Yield progress events per query, then the final document."""
        import asyncio

        queries = Parser.parse(document)
        yield {"type": "start", "num_queries": len(queries)}
        results = []
        for i, q in enumerate(queries):
            yield {"type": "progress", "query_index": i, "query": q.text}
            result = await asyncio.to_thread(self.processor.run, q)
            results.append(result)
            yield {
                "type": "query_complete",
                "query_index": i,
                "num_spans": len(result.spans),
                "error": result.error,
            }
        response = self._build_response(document, results)
        yield {
            "type": "done",
            "document": response.document,
            "citations": response.citations,
        }

    def _build_response(
        self, document: str, results: list[QueryResult]
    ) -> VerbatimDocResponse:
        # Global citation numbering across queries, deduped by (text, title).
        numbering: dict[int, int] = {}
        citations: list[dict[str, Any]] = []
        seen: dict[tuple[str, str], int] = {}
        next_number = 1
        for result in results:
            for span in result.spans:
                key = (span["text"], span["doc_title"])
                if key in seen:
                    numbering[id(span)] = seen[key]
                    continue
                seen[key] = next_number
                numbering[id(span)] = next_number
                citations.append(
                    {
                        "number": next_number,
                        "text": span["text"],
                        "doc_title": span["doc_title"],
                    }
                )
                next_number += 1

        final = Replacer.apply(document, results, numbering)
        return VerbatimDocResponse(document=final, queries=results, citations=citations)
