"""Template subsystem: strategies that arrange verbatim spans into answers."""

from .base import TemplateStrategy
from .contextual import ContextualTemplate
from .filler import TemplateFiller
from .manager import TemplateManager
from .question_specific import QuestionSpecificTemplate
from .random import RandomTemplate
from .static import StaticTemplate
from .structured import StructuredTemplate

__all__ = [
    "TemplateStrategy",
    "TemplateFiller",
    "TemplateManager",
    "StaticTemplate",
    "ContextualTemplate",
    "RandomTemplate",
    "QuestionSpecificTemplate",
    "StructuredTemplate",
]
