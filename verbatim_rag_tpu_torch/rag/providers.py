"""Provider adapters bridging the engine to the RAG-agnostic core.

Copy of `verbatim_rag_tpu/rag/providers.py`: `IndexProvider` and
`VerbatimRAGProvider` turn the port's engine objects into context-dict
providers consumable by `verbatim_query` / `VerbatimTransform`.
"""

from __future__ import annotations

from typing import Any

from verbatim_rag_tpu_torch.core.providers import RAGProvider


class IndexProvider(RAGProvider):
    """Adapter: a VerbatimIndex as a context provider."""

    def __init__(self, index, search_type: str | None = None):
        self.index = index
        self.search_type = search_type

    def retrieve(self, question: str, k: int = 5, filter=None) -> list[dict[str, Any]]:
        results = self.index.query(question, k=k, filter=filter, search_type=self.search_type)
        return [
            {
                "content": r.text,
                "title": (r.metadata or {}).get("title", ""),
                "source": (r.metadata or {}).get("source", ""),
                "metadata": r.metadata or {},
            }
            for r in results
        ]


class VerbatimRAGProvider(RAGProvider):
    """Adapter: a full VerbatimRAG as a context provider (uses its index +
    reranker but not its answer pipeline)."""

    def __init__(self, rag):
        self.rag = rag

    def retrieve(self, question: str, k: int = 5, filter=None) -> list[dict[str, Any]]:
        results = self.rag.index.query(question, k=k, filter=filter)
        results = self.rag._apply_reranker(question, results)
        return [
            {
                "content": r.text,
                "title": (r.metadata or {}).get("title", ""),
                "source": (r.metadata or {}).get("source", ""),
                "metadata": r.metadata or {},
            }
            for r in results
        ]
