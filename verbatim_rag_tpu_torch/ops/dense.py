"""Dense brute-force retrieval: matmul + top-k (port of
`verbatim_rag_tpu/ops/dense.py`, bf16/f32 corpora).

Two rules carried over from the JAX package so scores and orders agree:

- a bf16 corpus is scored with bf16 operands and a float32 result
  (``preferred_element_type=float32`` in JAX); a plain bf16 matmul in torch
  would round the *output* to bf16 and reorder near-equal scores;
- selection is exact with the lowest index first among equal values, like
  ``lax.top_k`` (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis (float32 math)."""
    x = x.float()
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result, whatever the operands' float dtype.

    On CUDA a bf16 product runs on the tensor cores with float32 output
    (``torch.mm(..., out_dtype=float32)``); elsewhere, and for float32, the
    operands are multiplied in float32 (products of bf16 values are exact
    in float32). TF32 is never used: float32 products stay float32.
    """
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def dense_scores(corpus: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """[B, N] cosine scores of row-normalized queries against a bf16/f32 corpus."""
    return matmul_f32(queries.to(corpus.dtype), corpus.t())


def _orderable(x: torch.Tensor) -> torch.Tensor:
    """float32 → int64 whose signed order is the float order (no NaNs)."""
    bits = x.float().contiguous().view(torch.int32).long()
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _topk_by_key(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each value packed with its reversed column index into one int64 key:
    every key is distinct, so ``torch.topk`` on the keys orders by (value
    desc, index asc)."""
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device, dtype=torch.int64)
    keys = (_orderable(scores) << 32) | (n - 1 - idx)
    _, pos = torch.topk(keys, k, dim=-1, sorted=True)
    return torch.gather(scores, -1, pos), pos


def topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis of [B, N] with ``lax.top_k``'s tie
    order: equal values come lowest index first.

    ``torch.topk`` on the float scores picks a correct set of values, but
    among values equal to the k-th it may keep any columns, and it orders
    equal values arbitrarily. The selected k are therefore re-sorted by
    (value desc, index asc), and only the rows where more columns tie with
    the k-th value than were kept are selected again with distinct int64
    keys (rows with masked −1e30 tails, duplicate documents).
    """
    vals, pos = torch.topk(scores, k, dim=-1, sorted=True)
    order = torch.argsort(pos, dim=-1)
    vals, pos = vals.gather(-1, order), pos.gather(-1, order)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)
    vals, pos = vals.gather(-1, order), pos.gather(-1, order)
    kth = vals[:, -1:]
    redo = (scores == kth).sum(-1) > (vals == kth).sum(-1)
    rows = redo.nonzero().squeeze(-1)
    if rows.numel():
        vals[rows], pos[rows] = _topk_by_key(scores[rows], k)
    return vals, pos


def candidate_topk(corpus, queries, k: int, mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, d] × [N, d] scores, masked rows at -1e30, then exact top-k."""
    scores = dense_scores(corpus, queries)
    if mask is not None:
        scores = torch.where(mask[None, :], scores, NEG_INF)
    return topk(scores, k)
