"""Optional / compatibility chunkers.

Copy of `verbatim_rag_tpu/ingestion/extra_chunkers.py` (pinned by
`tests/test_torch_copies.py`):

- `ChonkieChunkerProvider` — wraps a chonkie recipe chunker; chonkie is
  optional, so it import-gates with a clear error.
- `HeadingPathWrapper` — attaches ancestor heading paths to ANY chunker's
  output.
- `ChunkingStrategy` / `chunk_with_strategy` — the deprecated strategy enum,
  mapped to the native chunkers.
"""

from __future__ import annotations

import re
from enum import Enum

from .chunkers import ChunkerProvider, MarkdownChunkerProvider, SimpleChunkerProvider

_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$", re.MULTILINE)


class ChonkieChunkerProvider(ChunkerProvider):
    """Wrap a chonkie recipe chunker when the optional package is present."""

    def __init__(self, recipe: str = "markdown", lang: str = "en", **kwargs):
        try:
            from chonkie import RecursiveChunker
        except ImportError as exc:
            raise ImportError(
                "ChonkieChunkerProvider requires the optional 'chonkie' package; "
                "use MarkdownChunkerProvider (native) instead."
            ) from exc
        self._chunker = RecursiveChunker.from_recipe(recipe, lang=lang, **kwargs)

    def chunk(self, text: str) -> list[tuple[str, str]]:
        return [(c.text, c.text) for c in self._chunker.chunk(text)]


class HeadingPathWrapper(ChunkerProvider):
    """Attach ancestor heading paths to any chunker's output.

    Works by locating each raw chunk in the source text and prefixing the
    headings in scope at that position into the enhanced text.
    """

    def __init__(self, inner: ChunkerProvider):
        self.inner = inner

    def chunk(self, text: str) -> list[tuple[str, str]]:
        headings = [
            (m.start(), len(m.group(1)), m.group(2).strip())
            for m in _HEADING_RE.finditer(text)
        ]
        out = []
        cursor = 0
        for raw, enhanced in self.inner.chunk(text):
            pos = text.find(raw, cursor)
            if pos >= 0:
                cursor = pos + len(raw)
            anchor = pos if pos >= 0 else cursor
            stack: list[tuple[int, str]] = []
            for h_pos, level, title in headings:
                if h_pos > anchor:
                    break
                while stack and stack[-1][0] >= level:
                    stack.pop()
                stack.append((level, title))
            path = [t for _, t in stack]
            if path:
                enhanced = f"[Section: {' > '.join(path)}]\n{enhanced}"
            out.append((raw, enhanced))
        return out


class ChunkingStrategy(Enum):
    """Deprecated strategy names (parity: `verbatim_rag/chunking.py`)."""

    MARKDOWN = "markdown"
    RECURSIVE = "recursive"
    FIXED = "fixed"
    SENTENCE = "sentence"


def chunk_with_strategy(
    text: str, strategy: ChunkingStrategy = ChunkingStrategy.MARKDOWN, **kwargs
) -> list[tuple[str, str]]:
    """Legacy entry point mapping strategy names to native chunkers."""
    if strategy in (ChunkingStrategy.MARKDOWN, ChunkingStrategy.RECURSIVE):
        return MarkdownChunkerProvider(**kwargs).chunk(text)
    if strategy == ChunkingStrategy.FIXED:
        return SimpleChunkerProvider(**kwargs).chunk(text)
    if strategy == ChunkingStrategy.SENTENCE:
        # Sentence-boundary sliding window.
        parts = re.split(r"(?<=[.!?])\s+", text)
        chunks, buf = [], ""
        size = kwargs.get("chunk_size", 1000)
        for part in parts:
            if buf and len(buf) + len(part) > size:
                chunks.append((buf, buf))
                buf = part
            else:
                buf = f"{buf} {part}".strip() if buf else part
        if buf:
            chunks.append((buf, buf))
        return chunks
    raise ValueError(f"Unknown strategy: {strategy}")
