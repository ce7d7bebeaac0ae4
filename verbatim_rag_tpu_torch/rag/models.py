"""Compatibility re-exports (parity: reference `verbatim_rag/models.py`)."""

from verbatim_rag_tpu_torch.core.models import (
    Citation,
    DocumentWithHighlights,
    Highlight,
    QueryResponse,
    StreamingResponse,
    StreamingResponseType,
    StructuredAnswer,
)

__all__ = [
    "Citation",
    "DocumentWithHighlights",
    "Highlight",
    "QueryResponse",
    "StreamingResponse",
    "StreamingResponseType",
    "StructuredAnswer",
]
