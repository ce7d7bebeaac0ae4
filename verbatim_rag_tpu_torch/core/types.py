"""Structural typing seams shared across the core.

Parity: reference `verbatim_core/types.py`. Everything downstream of retrieval
only needs `.text` — extractors, templates and the response builder are
duck-typed against this protocol so they work with any retrieval backend.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class HasText(Protocol):
    text: str
