"""Orchestration layer: VerbatimRAG, streaming, intent."""

from .core import VerbatimRAG
from .intent import IntentDecision, IntentDetector, IntentSpec, LLMIntentDetector
from .streaming import StreamingRAG

__all__ = [
    "IntentDecision",
    "IntentDetector",
    "IntentSpec",
    "LLMIntentDetector",
    "StreamingRAG",
    "VerbatimRAG",
]
