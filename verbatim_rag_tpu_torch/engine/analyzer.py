"""BM25 analyzer: lowercase word tokens hashed into a fixed vocabulary.

The JAX store (`verbatim_rag_tpu/engine/store.py::_analyze`) runs the C++
scanner of `native/verbatim_host.cpp::analyze_text` when that library loads,
and a Python fallback otherwise; the two order the terms differently (first
occurrence against ascending id), and the ingest's "heaviest
``full_text_max_nnz`` terms" cut depends on that order when counts tie. This
module runs the same scanner, compiled from the port's own copy
(`engine/native.py`, `csrc/host/`), and returns what the JAX store's
analyzer returns on a machine where the scanner loads:

- the text's UTF-8 bytes (undecodable characters dropped), ASCII-lowercased;
  tokens are runs of ``[a-z0-9]``, every other byte separates;
- each token's first 256 bytes are hashed with 32-bit FNV-1a into slot
  ``hash % (vocab − 1) + 1`` (slot 0 is padding);
- unique slots in order of first occurrence, with their counts, and the
  document length (the number of tokens);
- a text with 4096 or more unique slots is past the scanner's buffer: the
  JAX store then takes its Python fallback (``re.findall`` over
  ``str.lower()``, unique slots ascending), and so does this module
  (:func:`analyze_fallback`, a copy of it).

:func:`analyze_texts` analyzes many texts in one scanner call (the batch
entry, in parallel over texts); :func:`analyze` is one text.
:func:`analyze_texts_plain` is the scanner's plain numpy version (one
vectorized pass over the concatenated bytes), which the tests and the card's
smoke run hold the scanner to.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from . import native

#: Bytes of a token that the scanner hashes (its token buffer).
TOKEN_BYTES = 256
#: Unique slots at which the scanner's buffer is full and the JAX store falls
#: back to the Python analyzer (`engine/native.py::analyze_text_native`).
SCANNER_MAX_TERMS = 4096
#: Texts analyzed per scanner call or vectorized pass (bounds their buffers).
CHUNK_TEXTS = 65536

_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)


def fnv1a(token: str) -> int:
    """FNV-1a 32-bit of a token's UTF-8 bytes."""
    h = 2166136261
    for byte in token.encode():
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


def analyze_fallback(text: str, vocab_size: int) -> tuple[np.ndarray, np.ndarray, int]:
    """The JAX store's Python analyzer: (unique slots ascending int32, their
    counts int32, document length)."""
    tokens = re.findall(r"[a-z0-9]+", text.lower())
    if not tokens:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    ids = np.fromiter(
        ((fnv1a(t[:TOKEN_BYTES]) % (vocab_size - 1)) + 1 for t in tokens),
        dtype=np.int64,
        count=len(tokens),
    )
    unique, counts = np.unique(ids, return_counts=True)
    return unique.astype(np.int32), counts.astype(np.int32), len(tokens)


def _scan(texts: Sequence[str], vocab_size: int):
    """One vectorized scanner pass: (slots int32, counts int32, offsets
    int64 [n+1], lengths int64 [n]) over every text, texts with too many
    unique slots included (the caller replaces those)."""
    n = len(texts)
    raws = [t.encode("utf-8", errors="ignore") for t in texts]
    sizes = np.fromiter(map(len, raws), np.int64, count=n)
    # One separator byte between texts, so no token spans two of them.
    text_start = np.concatenate(([0], np.cumsum(sizes + 1)[:-1])) if n else np.zeros(0, np.int64)
    data = np.frombuffer(b" ".join(raws), np.uint8)
    low = data | (((data >= 65) & (data <= 90)).astype(np.uint8) << 5)
    alnum = ((low >= 97) & (low <= 122)) | ((low >= 48) & (low <= 57))
    edges = np.diff(np.concatenate(([0], alnum.view(np.int8), [0])))
    tok_start = np.flatnonzero(edges == 1)
    tok_len = np.minimum(np.flatnonzero(edges == -1) - tok_start, TOKEN_BYTES)

    h = np.full(tok_start.size, _FNV_OFFSET, np.uint32)
    active = np.arange(tok_start.size)
    j = 0
    while active.size:
        b = low[tok_start[active] + j].astype(np.uint32)
        h[active] = (h[active] ^ b) * _FNV_PRIME
        j += 1
        active = active[tok_len[active] > j]
    slots = (h % np.uint32(vocab_size - 1)).astype(np.int64) + 1

    tok_doc = np.searchsorted(text_start, tok_start, side="right") - 1
    lengths = np.bincount(tok_doc, minlength=n).astype(np.int64)
    keys, first, counts = np.unique(tok_doc * vocab_size + slots, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")  # docs stay in order; first occurrence within
    uniq_doc = keys[order] // vocab_size
    offsets = np.concatenate(([0], np.cumsum(np.bincount(uniq_doc, minlength=n))))
    return (
        (keys[order] % vocab_size).astype(np.int32),
        counts[order].astype(np.int32),
        offsets.astype(np.int64),
        lengths,
    )


def analyze_texts(texts: Sequence[str], vocab_size: int):
    """Analyze many texts: (slots int32, counts int32, offsets int64 [n+1],
    lengths int64 [n]); text i's unique slots are ``slots[offsets[i]:
    offsets[i+1]]``, in the order :func:`analyze` gives them. One scanner
    call per CHUNK_TEXTS texts."""
    parts = [
        native.analyze_batch(texts[s : s + CHUNK_TEXTS], vocab_size, SCANNER_MAX_TERMS)
        for s in range(0, len(texts), CHUNK_TEXTS)
    ]
    return _gather(parts, texts, vocab_size)


def analyze_texts_plain(texts: Sequence[str], vocab_size: int):
    """The plain version of :func:`analyze_texts` (numpy, no compiled
    code): the same four arrays."""
    parts = [_scan(texts[s : s + CHUNK_TEXTS], vocab_size) for s in range(0, len(texts), CHUNK_TEXTS)]
    return _gather(parts, texts, vocab_size)


def _gather(parts, texts: Sequence[str], vocab_size: int):
    """Concatenate per-chunk results; texts at SCANNER_MAX_TERMS or more
    unique slots take the JAX store's Python fallback."""
    if not parts:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(1, np.int64), np.zeros(0, np.int64)
    slots = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    bases = np.cumsum([0] + [p[0].size for p in parts[:-1]])
    offsets = np.concatenate([[0]] + [p[2][1:] + base for p, base in zip(parts, bases)])
    lengths = np.concatenate([p[3] for p in parts])
    full = np.flatnonzero(np.diff(offsets) >= SCANNER_MAX_TERMS)
    if full.size:
        slots_l = np.split(slots, offsets[1:-1])
        counts_l = np.split(counts, offsets[1:-1])
        for i in full:
            slots_l[i], counts_l[i], lengths[i] = analyze_fallback(texts[i], vocab_size)
        slots, counts = np.concatenate(slots_l), np.concatenate(counts_l)
        offsets = np.concatenate(([0], np.cumsum([s.size for s in slots_l]))).astype(np.int64)
    return slots, counts, offsets, lengths


def analyze(text: str, vocab_size: int) -> tuple[np.ndarray, np.ndarray, int]:
    """One text: (unique slots int32, their counts int32, document length)."""
    slots, counts, _, lengths = analyze_texts([text], vocab_size)
    return slots, counts, int(lengths[0])
