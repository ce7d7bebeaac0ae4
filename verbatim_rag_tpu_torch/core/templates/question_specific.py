"""Question-routed template strategy.

Parity: reference `verbatim_core/templates/question_specific.py` — the user
registers (template, example-questions) pairs; at query time the incoming
question is routed to the template whose examples are most similar.

TPU-first design difference: the reference hard-wires a sentence-transformers
MiniLM for routing (`question_specific.py:140-187`). Here the embedding
function is *injected* so the engine can plug in the JAX/TPU dense encoder,
and the device-free default is a hashed bag-of-words cosine that needs no
model at all. Core stays importable without any accelerator.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import Any, Callable, Sequence

from .base import TemplateStrategy
from .filler import SpanData, TemplateFiller

EmbedFn = Callable[[Sequence[str]], list[list[float]]]

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_HASH_DIM = 512


def _stable_slot(token: str) -> int:
    digest = hashlib.blake2b(token.encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little") % _HASH_DIM


def _hashed_bow_embed(texts: Sequence[str]) -> list[list[float]]:
    """Deterministic, dependency-free embedding: hashed unigram counts."""
    out = []
    for text in texts:
        vec = [0.0] * _HASH_DIM
        for tok in _TOKEN_RE.findall(text.lower()):
            vec[_stable_slot(tok)] += 1.0
        out.append(vec)
    return out


def _cosine(a: Sequence[float], b: Sequence[float]) -> float:
    dot = sum(x * y for x, y in zip(a, b))
    na = math.sqrt(sum(x * x for x in a))
    nb = math.sqrt(sum(y * y for y in b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return dot / (na * nb)


class QuestionSpecificTemplate(TemplateStrategy):
    """Route each question to the best-matching user-defined template."""

    def __init__(
        self,
        citation_mode: str = "inline",
        citation_format: str = "[{number}]",
        embed_fn: EmbedFn | None = None,
        fallback_template: str | None = None,
    ):
        self.citation_mode = citation_mode
        self.filler = TemplateFiller(citation_mode=citation_mode, citation_format=citation_format)
        self.embed_fn = embed_fn or _hashed_bow_embed
        self.fallback_template = (
            fallback_template or "Relevant excerpts:\n\n[DISPLAY_SPANS]\n\n[CITATION_REFS]"
        )
        # Each entry: {"template": str, "questions": [str], "_embeddings": [[float]]}
        self.entries: list[dict[str, Any]] = []

    # -- registration -----------------------------------------------------------

    def add_template(self, template: str, example_questions: list[str]) -> None:
        self.validate_template(template)
        if not example_questions:
            raise ValueError("At least one example question is required")
        self.entries.append(
            {
                "template": template,
                "questions": list(example_questions),
                "_embeddings": self.embed_fn(example_questions),
            }
        )

    def clear(self) -> None:
        self.entries.clear()

    @property
    def uses_default_embed(self) -> bool:
        """True while routing on the model-free hashed-BoW default."""
        return self.embed_fn is _hashed_bow_embed

    def set_embed_fn(self, embed_fn: EmbedFn) -> None:
        """Swap the routing embedding (e.g. the engine's neural dense
        provider — the reference routes with MiniLM cosine,
        `question_specific.py:140-187`) and re-embed registered examples."""
        self.embed_fn = embed_fn
        for entry in self.entries:
            entry["_embeddings"] = embed_fn(entry["questions"])

    # -- strategy interface -------------------------------------------------------

    def generate(self, question: str, spans: list[str], citation_count: int = 0) -> str:
        if not self.entries:
            return self.fallback_template
        [q_vec] = self.embed_fn([question])
        best_template, best_score = self.fallback_template, -1.0
        for entry in self.entries:
            score = max(_cosine(q_vec, ex) for ex in entry["_embeddings"])
            if score > best_score:
                best_score, best_template = score, entry["template"]
        return best_template

    def fill(
        self,
        template: str,
        display_spans: list[SpanData],
        citation_spans: list[SpanData],
    ) -> str:
        return self.filler.fill(template, display_spans, citation_spans)

    def save_state(self) -> dict[str, Any]:
        return {
            "type": "question_specific",
            "templates": [
                {"template": e["template"], "questions": e["questions"]} for e in self.entries
            ],
            "fallback_template": self.fallback_template,
        }

    def load_state(self, state: dict[str, Any]) -> None:
        self.fallback_template = state.get("fallback_template", self.fallback_template)
        self.entries = []
        for item in state.get("templates", []):
            try:
                self.add_template(item["template"], item["questions"])
            except (KeyError, ValueError):
                continue

    def set_citation_mode(self, citation_mode: str) -> None:
        self.citation_mode = citation_mode
        self.filler.set_citation_mode(citation_mode)
