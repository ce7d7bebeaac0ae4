"""Decorator that retrofits verbatim answers onto any existing RAG function.

Copy of `verbatim_rag_tpu/core/enhance.py`: the wrapped function may return
a dict (with context/sources), an (answer, sources) tuple, a bare list, or raw
text; the return value is coerced to context dicts and re-answered verbatim.
"""

from __future__ import annotations

from functools import wraps
from typing import Any, Callable, Mapping

from .transform import VerbatimTransform


def _to_context_dicts(obj: Any) -> list[dict]:
    """Best-effort coercion of arbitrary RAG outputs to context dicts."""
    if obj is None:
        return []
    if isinstance(obj, Mapping):
        data = dict(obj)
        if "content" in data or "text" in data:
            return [
                {
                    "content": data.get("content") or data.get("text"),
                    "title": data.get("title", ""),
                    "source": data.get("source", ""),
                    "metadata": data.get("metadata") or {},
                }
            ]
        return []
    if isinstance(obj, (list, tuple)):
        out: list[dict] = []
        for item in obj:
            out.extend(_to_context_dicts(item))
        return out
    if isinstance(obj, str) and obj.strip():
        return [{"content": obj}]
    return []


def verbatim_enhance(
    max_display_spans: int = 5,
    transform: VerbatimTransform | None = None,
) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Wrap a RAG function so its context is re-answered verbatim.

    The wrapped function may return:
      - a dict with 'context' or 'sources' (and optionally 'answer'/'question')
      - a tuple (answer, sources)
      - a bare context list / dict / string
    A provided answer is currently ignored — the verbatim answer is always
    derived from the context.
    """

    def decorator(fn: Callable[..., Any]) -> Callable[..., Any]:
        @wraps(fn)
        def wrapper(*args, **kwargs):
            result = fn(*args, **kwargs)
            # First STRING positional, not args[0]: on a decorated bound
            # method args[0] is `self`, and passing the instance as the
            # question builds the extraction prompt around its repr.
            question = kwargs.get("question") or next(
                (a for a in args if isinstance(a, str)), ""
            )
            answer = None
            context: Any = []

            if isinstance(result, dict):
                answer = result.get("answer")
                context = result.get("context") or result.get("sources") or []
            elif isinstance(result, tuple) and len(result) == 2:
                # Only a TUPLE is (answer, sources) — a bare 2-item context
                # LIST must stay a context list, not lose its first chunk.
                answer, context = result
            else:
                context = result

            vt = transform or VerbatimTransform(max_display_spans=max_display_spans)
            return vt.transform(
                question=question or "", context=_to_context_dicts(context), answer=answer
            )

        return wrapper

    return decorator
