"""Orchestration layer: VerbatimRAG."""

from .core import VerbatimRAG

__all__ = ["VerbatimRAG"]
