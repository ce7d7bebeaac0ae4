"""Fused hybrid query pipeline: dense + projected sparse + RRF (port of
`verbatim_rag_tpu/ops/hybrid.py`, the 2-way program).

One call per query batch: dense candidate matmul + top-k, sketch candidate
matmul + top-`depth`, exact sparse rescore of those candidates, weighted RRF
on the tensors' device. The only host work is the caller's [B, k] readback.
"""

from __future__ import annotations

import torch

from .dense import NEG_INF, candidate_topk, topk
from .fusion import rrf_fuse_device


def exact_rescore_device(cand_rows, sp_ids, sp_w, q_ids, q_w) -> torch.Tensor:
    """The "scan" plain version: exact scores [B, C] f32, one step per query
    term (rows < 0 → -1e30)."""
    safe = cand_rows.clamp(min=0).reshape(-1)
    m = sp_ids.shape[1]
    cand_ids = sp_ids.index_select(0, safe).reshape(*cand_rows.shape, m).to(torch.int32)
    cand_w = sp_w.index_select(0, safe).reshape(*cand_rows.shape, m).float()
    scores = torch.zeros(cand_rows.shape, dtype=torch.float32, device=cand_rows.device)
    for t_id, t_w in zip(q_ids.t().to(torch.int32), q_w.t().float()):
        hit = torch.where(cand_ids == t_id[:, None, None], cand_w, 0.0).sum(dim=-1)
        scores = scores + t_w[:, None] * hit
    return torch.where(cand_rows >= 0, scores, NEG_INF)


def rescore_fn(impl: str):
    """Exact-rescore strategy: "scan" and "oneshot" are plain torch;
    "pallas" (the store default, named after the TPU kernel so saved configs
    read the same) is the hand-written CUDA kernel on CUDA tensors."""
    if impl == "scan":
        return exact_rescore_device
    if impl == "oneshot":
        from .rescore import exact_rescore_oneshot

        return exact_rescore_oneshot
    if impl == "pallas":
        from .rescore import exact_rescore_dispatch

        return exact_rescore_dispatch
    raise ValueError(f"unknown rescore impl {impl!r}")


def validate_candidate_impl(impl: str) -> str:
    """Per-stage candidate impl: "xla" (score matrix + exact top-k) or
    "bucket" (the fused matmul + bucket-max kernel). "section" is a
    whole-program impl dispatched by the store; it never reaches these
    per-stage programs."""
    if impl not in ("xla", "bucket"):
        raise ValueError(f"candidate_impl must be 'xla' or 'bucket', got {impl!r}")
    return impl


def projected_sparse_topk(
    sketch_corpus, sp_ids, sp_w, sketch_q, q_ids, q_w, k: int, depth: int,
    mask=None, exact_topk: bool = True, sketch_scale=None, rescore_impl: str = "scan",
    candidate_impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sketch-matmul candidates → exact forward-index rescore → top-k:
    (exact scores [B, k], rows [B, k]; −1 where missing). A zero exact score
    (no term overlap) is not a hit."""
    impl = validate_candidate_impl(candidate_impl)
    c_top, cand = candidate_topk(
        sketch_corpus, sketch_q, depth, mask, sketch_scale, exact_topk, impl
    )
    cand = torch.where(c_top > NEG_INF / 2, cand, -1).to(torch.int32)
    exact = rescore_fn(rescore_impl)(cand, sp_ids, sp_w, q_ids, q_w)
    top_scores, pos = topk(exact, k)
    rows = torch.gather(cand.long(), 1, pos)
    rows = torch.where(top_scores > 0.0, rows, -1)
    return top_scores, rows


def hybrid_fused_topk(
    dense_corpus, sketch_corpus, sp_ids, sp_w, dense_q, sketch_q, q_ids, q_w,
    k: int, fetch_k: int, depth: int, mask=None,
    dense_weight: float = 0.5, sparse_weight: float = 0.5, rrf_k: int = 60,
    exact_topk: bool = True, dense_scale=None, sketch_scale=None,
    rescore_impl: str = "scan", candidate_impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2-way hybrid query: (fused RRF scores [B, k], rows [B, k]; −1 pads).

    Selection on the "xla" path is exact whatever ``exact_topk`` says;
    ``exact_topk=True`` only keeps "bucket" requests off the bucket table.
    """
    impl = validate_candidate_impl(candidate_impl)
    d_top, d_rows = candidate_topk(
        dense_corpus, dense_q, fetch_k, mask, dense_scale, exact_topk, impl
    )
    d_rows = torch.where(d_top > NEG_INF / 2, d_rows, -1).long()
    _, s_rows = projected_sparse_topk(
        sketch_corpus, sp_ids, sp_w, sketch_q, q_ids, q_w, fetch_k, depth,
        mask, exact_topk, sketch_scale, rescore_impl, impl,
    )
    total = dense_weight + sparse_weight
    weights = torch.tensor(
        [dense_weight, sparse_weight], dtype=torch.float32, device=d_rows.device
    ) / torch.tensor(total, dtype=torch.float32, device=d_rows.device)
    stacked = torch.stack([d_rows, s_rows])  # [2, B, fetch_k]
    return rrf_fuse_device(stacked, weights, k=min(k, fetch_k), rrf_k=rrf_k)
