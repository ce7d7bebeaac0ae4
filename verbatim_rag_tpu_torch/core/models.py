"""Device-free data model for verbatim answers.

Behavioral parity target: reference `verbatim_core/models.py:1-64` — the same
set of response objects (highlight offsets, cited documents, structured answer,
streaming event envelope), re-expressed for the TPU engine. All offsets are
character offsets into the *original* chunk text (never the enhanced text),
which is the provenance contract the whole framework enforces.
"""

from __future__ import annotations

from enum import Enum
from typing import Any

from pydantic import BaseModel, Field, model_validator


class Highlight(BaseModel):
    """A verbatim character span inside a document."""

    text: str = Field(..., min_length=1)
    start: int = Field(..., ge=0)
    end: int = Field(..., ge=0)

    @model_validator(mode="after")
    def _check_span_nonempty(self) -> "Highlight":
        if self.end <= self.start:
            raise ValueError("end must be greater than start")
        return self


class DocumentWithHighlights(BaseModel):
    """A retrieved document plus the spans highlighted inside it."""

    content: str = Field(..., min_length=1)
    highlights: list[Highlight] = Field(default_factory=list)
    title: str = Field(default="")
    source: str = Field(default="")
    metadata: dict[str, Any] = Field(default_factory=dict)


class Citation(BaseModel):
    """One numbered citation pointing at (doc_index, highlight_index)."""

    text: str = Field(..., min_length=1)
    doc_index: int = Field(..., ge=0)
    highlight_index: int = Field(..., ge=0)
    number: int | None = Field(default=None, ge=1)
    type: str | None = Field(default=None)  # "display" | "reference"


class StructuredAnswer(BaseModel):
    text: str = Field(..., min_length=1)
    citations: list[Citation] = Field(default_factory=list)


class QueryResponse(BaseModel):
    """The complete answer object returned by every query entry point."""

    model_config = {"arbitrary_types_allowed": True}

    question: str = Field(..., min_length=1)
    answer: str = Field(..., min_length=1)
    structured_answer: StructuredAnswer
    documents: list[DocumentWithHighlights] = Field(default_factory=list)


class StreamingResponseType(Enum):
    DOCUMENTS = "documents"
    HIGHLIGHTS = "highlights"
    ANSWER = "answer"


class StreamingResponse(BaseModel):
    """Envelope for one stage of the streaming query protocol."""

    type: StreamingResponseType
    data: Any
    done: bool = False
