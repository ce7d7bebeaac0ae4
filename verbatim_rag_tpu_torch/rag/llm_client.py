"""Compatibility re-export (parity: reference `verbatim_rag/llm_client.py`)."""

from verbatim_rag_tpu_torch.core.llm_client import LLMClient

__all__ = ["LLMClient"]
