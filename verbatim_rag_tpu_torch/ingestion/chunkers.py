"""Chunkers: text → (raw, enhanced) chunk pairs.

Parity: reference `verbatim_rag/chunker_providers.py` — the `ChunkerProvider`
contract (`chunk(text) -> [(raw, enhanced), ...]`, L13-32) and the
`MarkdownChunkerProvider` semantics (L35-455):

- split on headings up to ``split_level`` (H1–H4);
- **lossless**: concatenating the raw chunks reproduces the input exactly;
- **ancestor heading injection**: each chunk's enhanced text is prefixed with
  the heading path above it;
- optional min-size merge of tiny chunks and max-size split at paragraph
  boundaries that never cuts **protected regions** — fenced code blocks and
  markdown tables (including an immediately preceding "Table N:" caption).

Pure host-side Python by design: chunking is I/O-bound string work that
feeds the batched device encode pipeline.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod

_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$")
_TABLE_ROW_RE = re.compile(r"^\s*\|.*\|\s*$")
_TABLE_CAPTION_RE = re.compile(r"^\s*\**Table\s+\d+", re.IGNORECASE)
_FENCE_RE = re.compile(r"^\s*(```|~~~)")


class ChunkerProvider(ABC):
    """Chunking contract: raw text in, (raw, enhanced) pairs out."""

    @abstractmethod
    def chunk(self, text: str) -> list[tuple[str, str]]:
        """:return: list of (raw_chunk, enhanced_chunk) pairs."""


class SimpleChunkerProvider(ChunkerProvider):
    """Fixed-size sliding window fallback (parity: `chunker_providers.py:531-572`)."""

    def __init__(self, chunk_size: int = 512, overlap: int = 50):
        if overlap >= chunk_size:
            raise ValueError("overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.overlap = overlap

    def chunk(self, text: str) -> list[tuple[str, str]]:
        if not text:
            return []
        chunks = []
        step = self.chunk_size - self.overlap
        for start in range(0, len(text), step):
            piece = text[start : start + self.chunk_size]
            if piece.strip():
                chunks.append((piece, piece))
            if start + self.chunk_size >= len(text):
                break
        return chunks


class MarkdownChunkerProvider(ChunkerProvider):
    """Heading-structured, lossless, protection-aware markdown chunker."""

    def __init__(
        self,
        split_level: int = 2,
        min_chunk_size: int = 0,
        max_chunk_size: int | None = None,
        include_heading_path: bool = True,
    ):
        self.split_level = split_level
        self.min_chunk_size = min_chunk_size
        self.max_chunk_size = max_chunk_size
        self.include_heading_path = include_heading_path

    # -- public ------------------------------------------------------------------

    def chunk(self, text: str) -> list[tuple[str, str]]:
        pairs = self.chunk_with_paths(text)
        return [(raw, enhanced) for raw, enhanced, _path in pairs]

    def chunk_with_paths(self, text: str) -> list[tuple[str, str, list[str]]]:
        """Like :meth:`chunk` but also returns each chunk's heading path."""
        if not text:
            return []
        sections = self._split_by_headings(text)
        if self.min_chunk_size:
            sections = self._merge_small(sections)
        if self.max_chunk_size:
            sections = self._split_large(sections)
        out = []
        for raw, path in sections:
            if not raw.strip():
                # Keep whitespace-only sections merged into nothing; they can
                # only appear as a leading slice — attach to preserve
                # losslessness by emitting them raw.
                out.append((raw, raw, list(path)))
                continue
            out.append((raw, self._enhance(raw, path), list(path)))
        return out

    # -- heading structure -----------------------------------------------------------

    def _split_by_headings(self, text: str) -> list[tuple[str, list[str]]]:
        lines = text.splitlines(keepends=True)
        sections: list[tuple[str, list[str]]] = []
        current: list[str] = []
        # Heading stack entries: (level, title).
        stack: list[tuple[int, str]] = []
        current_path: list[str] = []
        in_fence = False
        fence_marker = ""

        def emit():
            nonlocal current
            if current:
                sections.append(("".join(current), list(current_path)))
                current = []

        for line in lines:
            fence = _FENCE_RE.match(line)
            if fence:
                marker = fence.group(1)
                if not in_fence:
                    in_fence, fence_marker = True, marker
                elif marker == fence_marker:
                    in_fence = False
                current.append(line)
                continue
            heading = None if in_fence else _HEADING_RE.match(line)
            if heading:
                level = len(heading.group(1))
                title = heading.group(2).strip()
                if level <= self.split_level:
                    # Ancestors are strictly shallower headings.
                    while stack and stack[-1][0] >= level:
                        stack.pop()
                    emit()
                    current_path = [t for _, t in stack]
                    stack.append((level, title))
                    current.append(line)
                    continue
                # Deeper heading: update stack for descendants but don't split.
                while stack and stack[-1][0] >= level:
                    stack.pop()
                stack.append((level, title))
            current.append(line)
        emit()
        return sections

    def _enhance(self, raw: str, path: list[str]) -> str:
        if not self.include_heading_path or not path:
            return raw
        breadcrumb = " > ".join(path)
        return f"[Section: {breadcrumb}]\n{raw}"

    # -- merge / split passes -----------------------------------------------------------

    def _merge_small(self, sections: list[tuple[str, list[str]]]) -> list[tuple[str, list[str]]]:
        merged: list[tuple[str, list[str]]] = []
        for raw, path in sections:
            if merged and len(merged[-1][0].strip()) < self.min_chunk_size:
                prev_raw, prev_path = merged[-1]
                merged[-1] = (prev_raw + raw, prev_path)
            else:
                merged.append((raw, path))
        # A trailing runt merges backward.
        if len(merged) >= 2 and len(merged[-1][0].strip()) < self.min_chunk_size:
            last_raw, _ = merged.pop()
            prev_raw, prev_path = merged[-1]
            merged[-1] = (prev_raw + last_raw, prev_path)
        return merged

    def _split_large(self, sections: list[tuple[str, list[str]]]) -> list[tuple[str, list[str]]]:
        out: list[tuple[str, list[str]]] = []
        for raw, path in sections:
            if len(raw) <= self.max_chunk_size:
                out.append((raw, path))
                continue
            for piece in self._split_section(raw):
                out.append((piece, path))
        return out

    def _split_section(self, raw: str) -> list[str]:
        """Split at paragraph boundaries, keeping protected units atomic."""
        units = _protected_units(raw)
        pieces: list[str] = []
        buf = ""
        for unit in units:
            if buf and len(buf) + len(unit) > self.max_chunk_size:
                pieces.append(buf)
                buf = unit
            else:
                buf += unit
        if buf:
            pieces.append(buf)
        return pieces


def _protected_units(text: str) -> list[str]:
    """Partition text into atomic units: protected blocks or paragraphs.

    Protected: fenced code blocks; runs of markdown table rows together with
    an immediately preceding "Table N:" caption line. Concatenation of the
    units reproduces the input exactly.
    """
    lines = text.splitlines(keepends=True)
    units: list[str] = []
    buf: list[str] = []
    i = 0

    def flush_paragraphs():
        """Split buffered non-protected lines at blank-line boundaries."""
        if not buf:
            return
        para: list[str] = []
        for ln in buf:
            para.append(ln)
            if ln.strip() == "":
                units.append("".join(para))
                para = []
        if para:
            units.append("".join(para))
        buf.clear()

    while i < len(lines):
        line = lines[i]
        fence = _FENCE_RE.match(line)
        if fence:
            flush_paragraphs()
            block = [line]
            marker = fence.group(1)
            i += 1
            while i < len(lines):
                block.append(lines[i])
                if _FENCE_RE.match(lines[i]) and _FENCE_RE.match(lines[i]).group(1) == marker:
                    i += 1
                    break
                i += 1
            units.append("".join(block))
            continue
        if _TABLE_ROW_RE.match(line):
            # Pull a directly preceding caption line into the protected block.
            block = []
            if buf and _TABLE_CAPTION_RE.match(buf[-1]):
                block.append(buf.pop())
            flush_paragraphs()
            while i < len(lines) and _TABLE_ROW_RE.match(lines[i]):
                block.append(lines[i])
                i += 1
            units.append("".join(block))
            continue
        buf.append(line)
        i += 1
    flush_paragraphs()
    return units
