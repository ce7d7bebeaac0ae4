"""Device-free verbatim answering: the span-extractor contracts and the
prompted extractor, span verification, template strategies, response models
and building, the LLM client, the RAG-agnostic transform and the
`verbatim_enhance` decorator (copies of the JAX package's `core` modules).
Importing this package never touches torch or any accelerator."""

from .enhance import verbatim_enhance
from .extractors import LLMSpanExtractor, SpanExtractor
from .llm_client import LLMClient
from .models import (
    Citation,
    DocumentWithHighlights,
    Highlight,
    QueryResponse,
    StreamingResponse,
    StreamingResponseType,
    StructuredAnswer,
)
from .response_builder import ResponseBuilder
from .span_verify import find_fuzzy_match, verify_spans
from .templates import (
    ContextualTemplate,
    QuestionSpecificTemplate,
    RandomTemplate,
    StaticTemplate,
    StructuredTemplate,
    TemplateFiller,
    TemplateManager,
    TemplateStrategy,
)
from .transform import VerbatimTransform, verbatim_query, verbatim_query_async
from .universal_document import UniversalDocument

__all__ = [
    "Citation",
    "ContextualTemplate",
    "DocumentWithHighlights",
    "Highlight",
    "LLMClient",
    "LLMSpanExtractor",
    "QueryResponse",
    "QuestionSpecificTemplate",
    "RandomTemplate",
    "ResponseBuilder",
    "SpanExtractor",
    "StaticTemplate",
    "StreamingResponse",
    "StreamingResponseType",
    "StructuredAnswer",
    "StructuredTemplate",
    "TemplateFiller",
    "TemplateManager",
    "TemplateStrategy",
    "UniversalDocument",
    "VerbatimTransform",
    "find_fuzzy_match",
    "verbatim_enhance",
    "verbatim_query",
    "verbatim_query_async",
    "verify_spans",
]
