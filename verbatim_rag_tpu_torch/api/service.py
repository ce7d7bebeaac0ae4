"""API service layer: request validation + health checks.

Parity: reference `api/services/rag_service.py` — non-empty question,
length cap, query passthrough, health_check.
"""

from __future__ import annotations

import asyncio
from typing import Any, Mapping


class ValidationError(ValueError):
    pass


class APIService:
    def __init__(self, rag, max_question_length: int = 1000):
        self.rag = rag
        self.max_question_length = max_question_length

    def validate_question(self, question: Any) -> str:
        if not isinstance(question, str) or not question.strip():
            raise ValidationError("question must be a non-empty string")
        question = question.strip()
        if len(question) > self.max_question_length:
            raise ValidationError(
                f"question exceeds the {self.max_question_length}-character limit"
            )
        return question

    async def query(self, question: str, **kwargs) -> Mapping[str, Any]:
        question = self.validate_question(question)
        response = await asyncio.to_thread(self.rag.query, question, **kwargs)
        return response.model_dump()

    async def query_async(self, question: str, **kwargs) -> Mapping[str, Any]:
        question = self.validate_question(question)
        response = await self.rag.query_async(question, **kwargs)
        return response.model_dump()

    def health_check(self) -> dict[str, Any]:
        try:
            stats = self.rag.index.inspect()
        except Exception as exc:
            return {"status": "error", "detail": str(exc)}
        return {"status": "ok", **stats}
