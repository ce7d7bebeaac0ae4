"""Document / chunk data model.

Parity: reference `verbatim_rag/document.py` — Document → Chunk hierarchy
with uuid ids, type enums, content-type inference from file extension, and
dict round-trips. The raw/enhanced text duality lives on the chunk: ``text``
is the verbatim source slice (provenance), ``enhanced_text`` adds heading and
document context for embedding only.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class DocumentType(Enum):
    MARKDOWN = "markdown"
    TEXT = "text"
    HTML = "html"
    PDF = "pdf"
    CSV = "csv"
    JSON = "json"
    OTHER = "other"


class ChunkType(Enum):
    PARAGRAPH = "paragraph"
    SECTION = "section"
    TABLE = "table"
    CODE = "code"
    OTHER = "other"


_EXTENSION_TYPES = {
    ".md": DocumentType.MARKDOWN,
    ".markdown": DocumentType.MARKDOWN,
    ".txt": DocumentType.TEXT,
    ".html": DocumentType.HTML,
    ".htm": DocumentType.HTML,
    ".pdf": DocumentType.PDF,
    ".csv": DocumentType.CSV,
    ".json": DocumentType.JSON,
}


def infer_document_type(source: str) -> DocumentType:
    """Guess the content type from a path/URL extension."""
    lowered = source.lower().split("?")[0]
    for ext, doc_type in _EXTENSION_TYPES.items():
        if lowered.endswith(ext):
            return doc_type
    return DocumentType.OTHER


@dataclass
class Chunk:
    text: str
    enhanced_text: str = ""
    chunk_type: ChunkType = ChunkType.PARAGRAPH
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    metadata: dict[str, Any] = field(default_factory=dict)
    heading_path: list[str] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "text": self.text,
            "enhanced_text": self.enhanced_text,
            "chunk_type": self.chunk_type.value,
            "metadata": self.metadata,
            "heading_path": self.heading_path,
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Chunk":
        return cls(
            id=data.get("id", str(uuid.uuid4())),
            text=data["text"],
            enhanced_text=data.get("enhanced_text", ""),
            chunk_type=ChunkType(data.get("chunk_type", "paragraph")),
            metadata=data.get("metadata", {}),
            heading_path=data.get("heading_path", []),
        )


@dataclass
class Document:
    content: str
    title: str = ""
    source: str = ""
    doc_type: DocumentType = DocumentType.TEXT
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    metadata: dict[str, Any] = field(default_factory=dict)
    chunks: list[Chunk] = field(default_factory=list)

    @classmethod
    def from_text(
        cls,
        content: str,
        title: str = "",
        source: str = "",
        metadata: dict[str, Any] | None = None,
    ) -> "Document":
        return cls(
            content=content,
            title=title,
            source=source,
            doc_type=infer_document_type(source) if source else DocumentType.TEXT,
            metadata=metadata or {},
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "content": self.content,
            "title": self.title,
            "source": self.source,
            "doc_type": self.doc_type.value,
            "metadata": self.metadata,
            "chunks": [c.to_dict() for c in self.chunks],
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Document":
        doc = cls(
            id=data.get("id", str(uuid.uuid4())),
            content=data["content"],
            title=data.get("title", ""),
            source=data.get("source", ""),
            doc_type=DocumentType(data.get("doc_type", "text")),
            metadata=data.get("metadata", {}),
        )
        doc.chunks = [Chunk.from_dict(c) for c in data.get("chunks", [])]
        return doc
