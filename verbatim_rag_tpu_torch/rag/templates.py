"""Compatibility re-exports (parity: reference `verbatim_rag/templates/__init__.py`)."""

from verbatim_rag_tpu_torch.core.templates import (
    ContextualTemplate,
    QuestionSpecificTemplate,
    RandomTemplate,
    StaticTemplate,
    StructuredTemplate,
    TemplateFiller,
    TemplateManager,
    TemplateStrategy,
)

__all__ = [
    "ContextualTemplate",
    "QuestionSpecificTemplate",
    "RandomTemplate",
    "StaticTemplate",
    "StructuredTemplate",
    "TemplateFiller",
    "TemplateManager",
    "TemplateStrategy",
]
