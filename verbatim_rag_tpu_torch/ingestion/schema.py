"""User-facing document schema.

Parity: reference `verbatim_rag/schema.py` — a forgiving pydantic model:
unknown keyword arguments are automatically routed into ``metadata`` via a
before-validator, plus `from_file` construction and type detection.
"""

from __future__ import annotations

from typing import Any

from pydantic import BaseModel, Field, model_validator

from .document import Document, DocumentType, infer_document_type

_KNOWN_FIELDS = {"content", "title", "source", "doc_type", "metadata", "id"}


class DocumentSchema(BaseModel):
    model_config = {"extra": "allow"}

    content: str
    title: str = ""
    source: str = ""
    doc_type: str = "text"
    id: str | None = None
    metadata: dict[str, Any] = Field(default_factory=dict)

    @model_validator(mode="before")
    @classmethod
    def _route_unknown_kwargs_to_metadata(cls, data: Any) -> Any:
        if not isinstance(data, dict):
            return data
        metadata = dict(data.get("metadata") or {})
        cleaned = {}
        for key, value in data.items():
            if key in _KNOWN_FIELDS:
                cleaned[key] = value
            else:
                metadata[key] = value
        cleaned["metadata"] = metadata
        return cleaned

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "DocumentSchema":
        doc_type = infer_document_type(path)
        if doc_type.value in ("markdown", "text"):
            with open(path, encoding="utf-8") as f:
                content = f.read()
        else:
            from .document_processor import DocumentProcessor

            content = DocumentProcessor().extract_content_from_file(path)
        return cls(
            content=content,
            source=kwargs.pop("source", path),
            title=kwargs.pop("title", path.rsplit("/", 1)[-1]),
            doc_type=doc_type.value,
            **kwargs,
        )

    @classmethod
    def from_url(cls, url: str, **kwargs) -> "DocumentSchema":
        from .document_processor import DocumentProcessor

        content = DocumentProcessor().extract_content_from_url(url)
        return cls(
            content=content,
            source=kwargs.pop("source", url),
            title=kwargs.pop("title", url),
            doc_type=infer_document_type(url).value,
            **kwargs,
        )

    def to_document(self) -> Document:
        """Flatten to the internal Document (metadata flattening parity:
        `verbatim_rag/index.py:102-126`)."""
        flat_metadata = _flatten_metadata(self.metadata)
        doc = Document(
            content=self.content,
            title=self.title,
            source=self.source,
            doc_type=DocumentType(self.doc_type)
            if self.doc_type in DocumentType._value2member_map_
            else DocumentType.OTHER,
            metadata=flat_metadata,
        )
        if self.id:
            doc.id = self.id
        return doc


def _flatten_metadata(metadata: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    """Flatten nested metadata dicts to dotted keys; keep scalars/lists as-is."""
    flat: dict[str, Any] = {}
    for key, value in metadata.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten_metadata(value, prefix=f"{name}."))
        else:
            flat[name] = value
    return flat
