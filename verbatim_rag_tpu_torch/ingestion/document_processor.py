"""Document processing: files → Documents.

Copy of `verbatim_rag_tpu/ingestion/document_processor.py`, trimmed to the
file reads `DocumentSchema.from_file` needs (markdown, text, CSV, JSON).
Other formats (HTML, PDF, URLs) come with a later slice of the port.
"""

from __future__ import annotations

import csv
import io
import json
from pathlib import Path

from .document import DocumentType, infer_document_type


def _csv_to_markdown(text: str) -> str:
    rows = list(csv.reader(io.StringIO(text)))
    if not rows:
        return ""
    out = ["| " + " | ".join(rows[0]) + " |", "|" + "---|" * len(rows[0])]
    out += ["| " + " | ".join(r) + " |" for r in rows[1:]]
    return "\n".join(out)


def _json_to_markdown(text: str) -> str:
    data = json.loads(text)
    return "```json\n" + json.dumps(data, indent=2) + "\n```"


class DocumentProcessor:
    """source file → markdown text."""

    def extract_content_from_file(self, path: str) -> str:
        doc_type = infer_document_type(path)
        if doc_type in (DocumentType.MARKDOWN, DocumentType.TEXT):
            return Path(path).read_text(encoding="utf-8")
        if doc_type == DocumentType.CSV:
            return _csv_to_markdown(Path(path).read_text(encoding="utf-8"))
        if doc_type == DocumentType.JSON:
            return _json_to_markdown(Path(path).read_text(encoding="utf-8"))
        raise NotImplementedError(
            f"Converting {path!r} ({doc_type.value}) is not ported yet; "
            "pre-convert it to markdown"
        )
