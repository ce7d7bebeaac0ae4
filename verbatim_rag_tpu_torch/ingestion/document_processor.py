"""Document processing: files/URLs → chunked Documents.

Copy of `verbatim_rag_tpu/ingestion/document_processor.py` (pinned by
`tests/test_torch_copies.py`): convert source documents to markdown, chunk,
and enrich with metadata; factory presets `for_embeddings` / `for_qa` /
`markdown_recursive` / `semantic`.

Conversion is pluggable: markdown/text/JSON/CSV/HTML are handled natively
(HTML via the stdlib-parser converter in `html_convert.py`, URLs through the
instance's ``http_get`` or httpx); PDF and other formats go to the
``converter`` (docling when importable, else a clear error). All chunking is
the native lossless markdown chunker.
"""

from __future__ import annotations

import csv
import io
import json
import logging
import os
from pathlib import Path
from typing import Iterable

from .chunkers import ChunkerProvider, MarkdownChunkerProvider, SimpleChunkerProvider
from .document import Document, DocumentType, infer_document_type

logger = logging.getLogger(__name__)


def _docling_convert(source: str) -> str:
    try:
        from docling.document_converter import DocumentConverter
    except ImportError as exc:
        raise RuntimeError(
            f"Converting {source!r} requires the optional 'docling' package "
            "(PDF/HTML conversion). Install docling or pre-convert to markdown."
        ) from exc
    result = DocumentConverter().convert(source)
    return result.document.export_to_markdown()


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
    """source → markdown → chunked Document.

    ``converter`` is the pluggable source→markdown function used for
    formats without a native path (PDF/HTML/URLs). Defaults to docling
    when importable; inject a callable to use another converter (or to
    exercise the conversion path offline in tests).
    """

    def __init__(self, chunker: ChunkerProvider | None = None, converter=None):
        self.chunker = chunker or MarkdownChunkerProvider(split_level=2, min_chunk_size=64)
        self.converter = converter or _docling_convert

    # -- conversion --------------------------------------------------------------

    def extract_content_from_file(self, path: str) -> str:
        doc_type = infer_document_type(path)
        if doc_type in (DocumentType.MARKDOWN, DocumentType.TEXT):
            return Path(path).read_text(encoding="utf-8")
        if doc_type == DocumentType.CSV:
            return _csv_to_markdown(Path(path).read_text(encoding="utf-8"))
        if doc_type == DocumentType.JSON:
            return _json_to_markdown(Path(path).read_text(encoding="utf-8"))
        if doc_type == DocumentType.HTML:
            from .html_convert import html_to_markdown

            return html_to_markdown(Path(path).read_text(encoding="utf-8"))
        return self.converter(path)

    def extract_content_from_url(self, url: str) -> str:
        """Fetch + convert a URL.

        HTML (and plain-text/markdown) responses are handled natively:
        httpx fetch → `html_convert.html_to_markdown`. Other content types
        (PDF etc.) route to the pluggable converter. ``http_get`` on the
        instance can be overridden to stub the network in tests.
        """
        import httpx

        get = getattr(self, "http_get", None) or (
            lambda u: httpx.get(u, follow_redirects=True, timeout=30.0)
        )
        try:
            resp = get(url)
        except Exception as exc:
            logger.info("Native fetch of %s failed (%s); using converter", url, exc)
            return self.converter(url)
        content_type = resp.headers.get("content-type", "").split(";")[0].strip()
        if content_type in ("text/html", "application/xhtml+xml"):
            from .html_convert import html_to_markdown

            return html_to_markdown(resp.text)
        if content_type in ("text/plain", "text/markdown"):
            return resp.text
        return self.converter(url)

    # -- processing ---------------------------------------------------------------

    def process_file(self, path: str, **metadata) -> Document:
        content = self.extract_content_from_file(path)
        doc = Document.from_text(
            content,
            title=metadata.pop("title", os.path.basename(path)),
            source=path,
            metadata=metadata,
        )
        self._chunk(doc)
        return doc

    def process_url(self, url: str, **metadata) -> Document:
        content = self.extract_content_from_url(url)
        doc = Document.from_text(
            content, title=metadata.pop("title", url), source=url, metadata=metadata
        )
        self._chunk(doc)
        return doc

    def process_directory(
        self,
        directory: str,
        extensions: tuple[str, ...] = (".md", ".txt", ".csv", ".json", ".html", ".htm"),
    ) -> Iterable[Document]:
        for path in sorted(Path(directory).rglob("*")):
            if path.suffix.lower() in extensions:
                try:
                    yield self.process_file(str(path))
                except Exception as exc:
                    logger.warning("Skipping %s: %s", path, exc)

    def _chunk(self, doc: Document) -> None:
        from .document import Chunk

        doc.chunks = [
            Chunk(text=raw, enhanced_text=enhanced)
            for raw, enhanced in self.chunker.chunk(doc.content)
            if raw.strip()
        ]

    # -- factory presets (parity: document_processor.py:242-283) --------------------

    @classmethod
    def for_embeddings(cls) -> "DocumentProcessor":
        """Chunks sized for dense embedding models (≈512-token windows)."""
        return cls(MarkdownChunkerProvider(split_level=3, min_chunk_size=128, max_chunk_size=2000))

    @classmethod
    def for_qa(cls) -> "DocumentProcessor":
        """Larger context-preserving chunks for extractive QA."""
        return cls(MarkdownChunkerProvider(split_level=2, min_chunk_size=256, max_chunk_size=6000))

    @classmethod
    def markdown_recursive(cls) -> "DocumentProcessor":
        """Deep heading-structured chunking."""
        return cls(MarkdownChunkerProvider(split_level=4, min_chunk_size=64))

    @classmethod
    def semantic(cls) -> "DocumentProcessor":
        """Sliding-window fallback when heading structure is absent."""
        return cls(SimpleChunkerProvider(chunk_size=1200, overlap=150))
