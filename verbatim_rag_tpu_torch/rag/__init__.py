"""Orchestration layer: VerbatimRAG, streaming, intent, rerankers, providers,
VerbatimDOC."""

from .core import VerbatimRAG
from .intent import IntentDecision, IntentDetector, IntentSpec, LLMIntentDetector
from .providers import IndexProvider, VerbatimRAGProvider
from .rerankers import (
    BaseReranker,
    CohereReranker,
    JaxReranker,
    JinaReranker,
    JinaV3Reranker,
    Reranker,
)
from .streaming import StreamingRAG
from .verbatim_doc import VerbatimDOC

__all__ = [
    "BaseReranker",
    "CohereReranker",
    "IndexProvider",
    "IntentDecision",
    "IntentDetector",
    "IntentSpec",
    "JaxReranker",
    "JinaReranker",
    "JinaV3Reranker",
    "LLMIntentDetector",
    "Reranker",
    "StreamingRAG",
    "VerbatimDOC",
    "VerbatimRAG",
    "VerbatimRAGProvider",
]
