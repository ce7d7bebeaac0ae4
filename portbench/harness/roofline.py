"""The yardstick's arithmetic: published peaks and the least time a kernel
needs for the work it was given.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``attention_pairs``,
``attention_rows`` and ``rescore_bound`` (the attention pairs of a banded
row are summed with numpy here rather than a Python loop, which counts the
same pairs; ``tests/test_portbench_metrics.py`` holds the two equal).
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, FP32 CUDA cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


def bound(bytes_moved: float, ops: float, op_rate: float) -> tuple[float, str]:
    """Least ms for ``bytes_moved`` bytes and ``ops`` operations at
    ``op_rate``, and which of the two sets it."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(lengths, seq: int, window) -> int:
    """Unmasked (query, key) pairs: every query row of [0, S) against keys
    below its row's length and, on local layers, inside the band."""
    total = 0
    q = np.arange(seq)
    for n in lengths:
        n = int(n)
        if n <= 0:
            continue
        if window is None:
            total += seq * n
            continue
        half = window // 2
        total += int(np.maximum(0, np.minimum(n - 1, q + half) - np.maximum(0, q - half) + 1).sum())
    return total


def attention_rows(lengths, seq: int) -> tuple[int, int]:
    """Rows of [S, H, D] an attention call must move for ``lengths``: query
    rows of the batch rows with a live key, and key rows below each row's
    length (k and v each). Outputs are written whole and counted by the
    caller."""
    q_rows = seq * sum(1 for n in lengths if int(n) > 0)
    kv_rows = sum(min(max(int(n), 0), seq) for n in lengths)
    return q_rows, kv_rows


def flash_bound(batch: int, seq: int, heads: int, head_dim: int, lengths, window) -> float:
    """A flash forward launch's least ms on bf16 operands (its lse, when
    asked for, is four bytes a row more and left out)."""
    pairs = attention_pairs(lengths, seq, window)
    q_rows, kv_rows = attention_rows(lengths, seq)
    return bound(
        (q_rows + 2 * kv_rows + batch * seq) * heads * head_dim * 2 + 4 * batch,
        4 * heads * head_dim * pairs,
        PEAK_BF16_FLOPS,
    )[0]


def rescore_bound(cand, ids, w, qm: int) -> tuple[float, str]:
    """The rescore's bound, counted from the run's data: of each live
    candidate's row, the id and weight of every live slot (weight not 0) and
    the weight alone of every pad slot; the candidate ids, the query terms
    and the scores; against a compare-select of each live slot with each
    query term on the CUDA cores."""
    valid = cand >= 0
    rows = cand[valid].long()
    live = int((w[rows] != 0).sum())
    pads = rows.numel() * w.shape[1] - live
    B, C = cand.shape
    row_bytes = live * (ids.element_size() + w.element_size()) + pads * w.element_size()
    return bound(row_bytes + B * C * 4 + B * qm * 8 + B * C * 4, live * qm, PEAK_FP32_OPS)
