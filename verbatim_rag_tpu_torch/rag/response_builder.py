"""Compatibility re-export (parity: reference `verbatim_rag/response_builder.py`)."""

from verbatim_rag_tpu_torch.core.response_builder import ResponseBuilder

__all__ = ["ResponseBuilder"]
