"""Search result record returned by every retrieval path.

Parity: reference `vector_stores/base.py:10-39` — {id, score, text,
enhanced_text, metadata}. `text` is the raw chunk (provenance source of
truth); `enhanced_text` carries heading/source context and is what gets
embedded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class SearchResult:
    id: str
    score: float = 0.0
    text: str = ""
    enhanced_text: str = ""
    metadata: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "score": self.score,
            "text": self.text,
            "enhanced_text": self.enhanced_text,
            "metadata": self.metadata,
        }
