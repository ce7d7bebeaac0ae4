"""Compatibility re-exports (parity: reference `verbatim_rag/extractors.py` —
the orchestration package mirrors the core extractor surface so reference
imports port 1:1)."""

from __future__ import annotations

from verbatim_rag_tpu_torch.core.extractors import LLMSpanExtractor, SpanExtractor
from verbatim_rag_tpu_torch.models.highlighter import (
    ModelSpanExtractor,
    SemanticHighlightExtractor,
)

__all__ = [
    "SpanExtractor",
    "ModelSpanExtractor",
    "LLMSpanExtractor",
    "SemanticHighlightExtractor",
]
