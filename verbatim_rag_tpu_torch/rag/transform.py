"""Compatibility re-exports (parity: reference `verbatim_rag/transform.py` —
the RAG-side transform entry points over SearchResult-shaped hits)."""

from verbatim_rag_tpu_torch.core.transform import (
    VerbatimTransform,
    verbatim_query,
    verbatim_query_async,
)

__all__ = ["VerbatimTransform", "verbatim_query", "verbatim_query_async"]
