"""Intent detection: route questions before retrieval.

Parity: reference `verbatim_rag/intent.py` — `IntentDecision{intent, route:
continue|predefined|skip, answer, confidence, reason}` (L16-33) and the
JSON-prompted `LLMIntentDetector` with example-driven intents, per-intent
route overrides, and a min-confidence fallback to "continue" (L43-144).
"""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

ROUTES = ("continue", "predefined", "skip")


@dataclass
class IntentDecision:
    intent: str = "default"
    route: str = "continue"
    answer: str | None = None
    confidence: float = 1.0
    reason: str = ""


@dataclass
class IntentSpec:
    """One recognizable intent: examples + how to route it."""

    name: str
    examples: list[str] = field(default_factory=list)
    route: str = "continue"
    answer: str | None = None
    description: str = ""


class IntentDetector(ABC):
    @abstractmethod
    def detect(self, question: str) -> IntentDecision: ...

    async def detect_async(self, question: str) -> IntentDecision:
        import asyncio

        return await asyncio.to_thread(self.detect, question)


class LLMIntentDetector(IntentDetector):
    """Classify questions into user-defined intents via a JSON-mode LLM call."""

    def __init__(
        self,
        llm_client,
        intents: list[IntentSpec] | None = None,
        min_confidence: float = 0.5,
        default_route: str = "continue",
    ):
        self.llm_client = llm_client
        self.intents = list(intents or [])
        self.min_confidence = min_confidence
        self.default_route = default_route

    def add_intent(self, spec: IntentSpec) -> None:
        self.intents.append(spec)

    def _prompt(self, question: str) -> str:
        blocks = []
        for spec in self.intents:
            examples = "; ".join(spec.examples[:5])
            blocks.append(
                f"- {spec.name}: {spec.description or 'no description'} "
                f"(examples: {examples})"
            )
        intents_block = "\n".join(blocks) or "- default: any retrieval question"
        return (
            "Classify the user question into one of these intents:\n"
            f"{intents_block}\n\n"
            f"Question: {question}\n\n"
            "Respond with ONLY a JSON object: "
            '{"intent": "<name>", "confidence": <0..1>, "reason": "<short>"}.'
            ' Use intent "default" if nothing fits.'
        )

    def detect(self, question: str) -> IntentDecision:
        try:
            raw = self.llm_client.complete(self._prompt(question), json_mode=True)
            data = json.loads(raw)
        except Exception as exc:
            logger.warning("Intent detection failed; continuing: %s", exc)
            return IntentDecision(reason=f"detector error: {exc}")

        name = str(data.get("intent", "default"))
        confidence = float(data.get("confidence", 0.0) or 0.0)
        reason = str(data.get("reason", ""))

        default = self.default_route if self.default_route in ROUTES else "continue"
        if confidence < self.min_confidence:
            return IntentDecision(
                intent=name, route=default, confidence=confidence, reason=reason
            )
        for spec in self.intents:
            if spec.name == name:
                return IntentDecision(
                    intent=name,
                    route=spec.route if spec.route in ROUTES else "continue",
                    answer=spec.answer,
                    confidence=confidence,
                    reason=reason,
                )
        return IntentDecision(
            intent=name, route=default, confidence=confidence, reason=reason
        )
