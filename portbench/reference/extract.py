"""The span extractor's host side, written from its description: each
(question, document) pair becomes rows of ``[question row] + a window of the
document's tokens + [sep]``, windows of ``max_length - len(question row) - 1``
tokens overlapping by ``stride``; a token's probability is its largest over
the windows that hold it; tokens at or above ``threshold`` form regions,
regions closer than ``merge_gap`` characters merge, and regions shorter
than ``min_chars`` drop. A response highlights every non-overlapping
occurrence of each span, earlier spans first."""

from __future__ import annotations

import numpy as np

from . import tokenizer


def windows(n_tokens: int, budget: int, stride: int) -> list[tuple[int, int]]:
    if n_tokens <= budget:
        return [(0, n_tokens)]
    out, start, step = [], 0, max(budget - stride, 1)
    while start < n_tokens:
        length = min(budget, n_tokens - start)
        out.append((start, length))
        if start + length >= n_tokens:
            break
        start += step
    return out


def plan(question: str, context: str, vocab: int, max_length: int, stride: int) -> dict:
    """The rows of one pair and where each window sits in the document."""
    ids, offsets = tokenizer.tokenize(context, vocab)
    q_row = tokenizer.framed(question, vocab, 512)
    budget = max(max_length - len(q_row) - 1, 16)
    rows, layout = [], []
    for start, length in windows(len(ids), budget, stride):
        rows.append(q_row + ids[start : start + length] + [tokenizer.SEP])
        layout.append((start, length, len(q_row)))
    return dict(rows=rows, layout=layout, n_tokens=len(ids), offsets=offsets)


def aggregate(p: dict, row_probs: list[np.ndarray]) -> np.ndarray:
    agg = np.zeros(p["n_tokens"], np.float32)
    for probs, (start, length, q_len) in zip(row_probs, p["layout"]):
        agg[start : start + length] = np.maximum(agg[start : start + length], probs[q_len : q_len + length])
    return agg


def spans(probs, offsets, threshold=0.2, min_chars=30, merge_gap=20) -> list[tuple[int, int]]:
    regions, cur = [], None
    for pr, (s, e) in zip(probs, offsets):
        if pr >= threshold:
            if cur is None:
                cur = [s, e]
            elif s - cur[1] > merge_gap:
                regions.append(cur)
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        elif cur is not None:
            regions.append(cur)
            cur = None
    if cur is not None:
        regions.append(cur)
    merged: list[list[int]] = []
    for r in regions:
        if merged and r[0] - merged[-1][1] <= merge_gap:
            merged[-1][1] = max(merged[-1][1], r[1])
        else:
            merged.append(r)
    return [(s, e) for s, e in merged if e - s >= min_chars]


def highlights(text: str, span_texts: list[str]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for span in span_texts:
        cursor = 0
        while (start := text.find(span, cursor)) != -1:
            end = start + len(span)
            if not any(start < b and end > a for a, b in out):
                out.append((start, end))
            cursor = end
    return out
