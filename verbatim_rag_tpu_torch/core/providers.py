"""Retrieval provider contract for the RAG-agnostic core.

Parity: reference `verbatim_core/providers.py` — anything that can fetch
context dicts for a question can drive the verbatim transform.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import Any


class RAGProvider(ABC):
    """Minimal retrieval interface the transform layer depends on."""

    @abstractmethod
    def retrieve(
        self, question: str, k: int = 5, filter: str | None = None
    ) -> list[dict[str, Any]]:
        """Return context dicts: {content, title?, source?, metadata?}."""

    async def retrieve_async(
        self, question: str, k: int = 5, filter: str | None = None
    ) -> list[dict[str, Any]]:
        return await asyncio.to_thread(self.retrieve, question, k, filter)
