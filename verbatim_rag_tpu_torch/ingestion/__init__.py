"""Ingestion: documents, schemas, chunkers (copies of the JAX package's)."""

from .chunkers import ChunkerProvider, MarkdownChunkerProvider, SimpleChunkerProvider
from .document import Chunk, ChunkType, Document, DocumentType, infer_document_type
from .schema import DocumentSchema

__all__ = [
    "Chunk",
    "ChunkType",
    "ChunkerProvider",
    "Document",
    "DocumentSchema",
    "DocumentType",
    "MarkdownChunkerProvider",
    "SimpleChunkerProvider",
    "infer_document_type",
]
