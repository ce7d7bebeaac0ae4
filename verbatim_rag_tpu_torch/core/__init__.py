"""Device-free verbatim answering: the span-extractor contract, response
models, response building and template strategies (copies of the JAX
package's `core` modules)."""

from .extractors import SpanExtractor
from .models import (
    Citation,
    DocumentWithHighlights,
    Highlight,
    QueryResponse,
    StructuredAnswer,
)
from .response_builder import ResponseBuilder
from .templates import TemplateManager

__all__ = [
    "Citation",
    "DocumentWithHighlights",
    "Highlight",
    "QueryResponse",
    "ResponseBuilder",
    "SpanExtractor",
    "StructuredAnswer",
    "TemplateManager",
]
