"""Compatibility re-export (parity: reference `verbatim_rag/universal_document.py`)."""

from verbatim_rag_tpu_torch.core.universal_document import UniversalDocument

__all__ = ["UniversalDocument"]
