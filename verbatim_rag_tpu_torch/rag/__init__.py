"""Orchestration layer: VerbatimRAG, streaming, intent, rerankers."""

from .core import VerbatimRAG
from .intent import IntentDecision, IntentDetector, IntentSpec, LLMIntentDetector
from .rerankers import (
    BaseReranker,
    CohereReranker,
    JaxReranker,
    JinaReranker,
    JinaV3Reranker,
    Reranker,
)
from .streaming import StreamingRAG

__all__ = [
    "BaseReranker",
    "CohereReranker",
    "IntentDecision",
    "IntentDetector",
    "IntentSpec",
    "JaxReranker",
    "JinaReranker",
    "JinaV3Reranker",
    "LLMIntentDetector",
    "Reranker",
    "StreamingRAG",
    "VerbatimRAG",
]
