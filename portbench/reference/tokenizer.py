"""Word-hash tokenization, written from its description: lower-case the
text, cut it into runs of ``[a-z0-9]`` and single punctuation marks, and map
each word to ``3 + blake2b-64(repr(word)) mod (vocab - 3)``. Ids 0, 1 and 2
are pad, cls and sep. Plain Python: nothing of the measured program."""

from __future__ import annotations

import hashlib
import re

PAD, CLS, SEP = 0, 1, 2
RESERVED = 3
WORD_RE = re.compile(r"[a-z0-9]+|[^\w\s]")


def word_id(word: str, vocab: int) -> int:
    digest = hashlib.blake2b(repr(word).encode(), digest_size=8).digest()
    return RESERVED + int.from_bytes(digest, "little", signed=True) % (vocab - RESERVED)


def tokenize(text: str, vocab: int) -> tuple[list[int], list[tuple[int, int]]]:
    """Every token of ``text``: (ids, character offsets)."""
    ids, offsets = [], []
    for m in WORD_RE.finditer(text.lower()):
        ids.append(word_id(m.group(0), vocab))
        offsets.append((m.start(), m.end()))
    return ids, offsets


def count_tokens(text: str) -> int:
    return sum(1 for _ in WORD_RE.finditer(text.lower()))


def framed(text: str, vocab: int, max_length: int) -> list[int]:
    """One text as an encoder row: cls, as many tokens as fit, and sep when
    there is room for it."""
    ids = tokenize(text, vocab)[0][:max_length]
    n = min(len(ids), max_length - 1)
    row = [CLS] + ids[:n]
    return row + [SEP] if n + 1 < max_length else row
