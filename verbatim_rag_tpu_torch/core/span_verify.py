"""Span verification — the provenance guarantee enforcement point.

Every span leaving an extractor passes through here before it can become a
highlight or citation. Two modes, parity with reference
`verbatim_core/extractors.py:778-916`:

- **exact**: a stripped span is kept iff it is a literal substring of the
  document.
- **fuzzy**: tolerant of OCR noise / punctuation-spacing drift. Both span and
  document are token-normalized (NFKC + casefold, words and punctuation as
  separate tokens joined by single spaces); rapidfuzz's partial-ratio
  alignment locates the span in the normalized document; the result is sliced
  back out of the ORIGINAL document text on token boundaries — the returned
  span is always the document's own text, never the extractor's, so highlight
  offsets stay exact.
"""

from __future__ import annotations

import logging
import re
import unicodedata
from dataclasses import dataclass

logger = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


@dataclass(frozen=True)
class NormalizedText:
    """Normalized text plus the maps back to the original character space."""

    text: str
    #: (start, end) of each token in the original string.
    source_spans: tuple[tuple[int, int], ...]
    #: (start, end) of each token in the normalized string.
    normalized_spans: tuple[tuple[int, int], ...]


def normalize_tokens(text: str) -> NormalizedText:
    """Tokenize into words/punctuation; NFKC + casefold each token; join by
    single spaces; remember both coordinate systems."""
    pieces: list[str] = []
    source_spans: list[tuple[int, int]] = []
    normalized_spans: list[tuple[int, int]] = []
    pos = 0
    for m in _TOKEN_RE.finditer(text):
        token = unicodedata.normalize("NFKC", m.group(0)).casefold()
        if not token:
            continue
        if pieces:
            pieces.append(" ")
            pos += 1
        start = pos
        pieces.append(token)
        pos += len(token)
        source_spans.append((m.start(), m.end()))
        normalized_spans.append((start, pos))
    return NormalizedText("".join(pieces), tuple(source_spans), tuple(normalized_spans))


def _slice_original(
    original: str, doc_norm: NormalizedText, norm_start: int, norm_end: int
) -> str:
    """Map a normalized-space range to original text, snapped to tokens."""
    first = last = None
    for i, (t_start, t_end) in enumerate(doc_norm.normalized_spans):
        if t_end <= norm_start:
            continue
        if t_start >= norm_end:
            break
        if first is None:
            first = i
        last = i
    if first is None or last is None:
        return ""
    return original[doc_norm.source_spans[first][0] : doc_norm.source_spans[last][1]]


def find_fuzzy_match(span: str, document_text: str) -> tuple[float, str]:
    """Best fuzzy location of ``span`` in ``document_text``.

    :return: (score in [0, 1], matched original-document text or "").
    """
    # Imported here, not with the module: exact mode needs no rapidfuzz, and
    # a machine without it still verifies exact spans.
    from rapidfuzz.fuzz import partial_ratio_alignment

    span_norm = normalize_tokens(span)
    doc_norm = normalize_tokens(document_text)
    if not span_norm.text or not doc_norm.text:
        return 0.0, ""
    alignment = partial_ratio_alignment(span_norm.text, doc_norm.text)
    matched = _slice_original(document_text, doc_norm, alignment.dest_start, alignment.dest_end)
    return alignment.score / 100.0, matched


def verify_spans(
    spans: list[str],
    document_text: str,
    mode: str = "exact",
    fuzzy_threshold: float = 0.8,
) -> list[str]:
    """Keep only spans that provably occur in the document.

    In exact mode the stripped span itself is returned; in fuzzy mode the
    *document's* text for the best alignment is returned (exact substring
    fast-path first).
    """
    verified: list[str] = []
    for raw in spans:
        span = raw.strip()
        if not span:
            continue
        if span in document_text:
            verified.append(span)
            continue
        if mode == "fuzzy":
            score, matched = find_fuzzy_match(span, document_text)
            if score >= fuzzy_threshold and matched:
                verified.append(matched)
                continue
            logger.warning(
                "Span not found in document (best fuzzy score %.2f): %r", score, span[:100]
            )
        else:
            logger.warning("Span not found verbatim in document: %r", span[:100])
    return verified
