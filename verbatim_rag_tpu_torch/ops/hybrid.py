"""Fused hybrid query pipeline: dense + projected sparse (+ BM25 full text)
+ RRF (port of `verbatim_rag_tpu/ops/hybrid.py`).

One call per query batch: dense candidate matmul + top-k, sketch candidate
matmul + top-`depth` per sparse arm (SPLADE, and BM25 in the 3-way program),
exact forward-index rescore of those candidates, weighted RRF on the
tensors' device. The only host work is the caller's [B, k] readback.
:func:`hybrid_topk` is the exact-scan variant (every row scored by the
forward-index scan of `ops/sparse.py`).
"""

from __future__ import annotations

import torch

from .dense import NEG_INF, candidate_topk, dense_scores, topk
from .fusion import rrf_fuse_device
from .sparse import sparse_topk


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


def hybrid_candidates(
    dense_corpus, sketch_corpus, dense_q, sketch_q, fetch_k: int, depth: int, mask=None,
    exact_topk: bool = True, dense_scale=None, sketch_scale=None, candidate_impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both hybrid candidate generations: (dense candidate rows [B, fetch_k],
    sparse candidate rows [B, depth]; −1 where masked out)."""
    impl = validate_candidate_impl(candidate_impl)
    d_top, d_rows = candidate_topk(
        dense_corpus, dense_q, fetch_k, mask, dense_scale, exact_topk, impl
    )
    s_top, s_rows = candidate_topk(
        sketch_corpus, sketch_q, depth, mask, sketch_scale, exact_topk, impl
    )
    d_rows = torch.where(d_top > NEG_INF / 2, d_rows, -1)
    s_rows = torch.where(s_top > NEG_INF / 2, s_rows, -1)
    return d_rows, s_rows


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
    weights = _arm_weights((dense_weight, sparse_weight), d_rows.device)
    stacked = torch.stack([d_rows, s_rows])  # [2, B, fetch_k]
    return rrf_fuse_device(stacked, weights, k=min(k, fetch_k), rrf_k=rrf_k)


def _arm_weights(weights, device) -> torch.Tensor:
    """RRF weights of the fused programs: each float32 weight over the
    float32 of their sum (taken in Python), as the JAX programs divide."""
    return torch.tensor(weights, dtype=torch.float32, device=device) / torch.tensor(
        sum(weights), dtype=torch.float32, device=device
    )


def hybrid_fused_topk_3way(
    dense_corpus, sketch_corpus, sp_ids, sp_w, ft_sketch, ft_ids, ft_w,
    dense_q, sketch_q, q_ids, q_w, ft_q_proj, ft_q_ids, ft_q_w,
    k: int, fetch_k: int, depth: int, mask=None,
    dense_weight: float = 1.0, sparse_weight: float = 1.0, ft_weight: float = 1.0,
    rrf_k: int = 60, exact_topk: bool = True, dense_scale=None, sketch_scale=None,
    ft_scale=None, rescore_impl: str = "scan", candidate_impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3-way hybrid (dense + SPLADE + BM25 full text) in one call: three
    candidate stages, two exact forward-index rescores (the SPLADE arm's
    and the BM25 arm's), 3-way weighted RRF.

    Returns (fused RRF scores [B, k], rows [B, k]; −1 pads).
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
    _, f_rows = projected_sparse_topk(
        ft_sketch, ft_ids, ft_w, ft_q_proj, ft_q_ids, ft_q_w, fetch_k, depth,
        mask, exact_topk, ft_scale, rescore_impl, impl,
    )
    weights = _arm_weights((dense_weight, sparse_weight, ft_weight), d_rows.device)
    stacked = torch.stack([d_rows, s_rows, f_rows])  # [3, B, fetch_k]
    return rrf_fuse_device(stacked, weights, k=min(k, fetch_k), rrf_k=rrf_k)


def hybrid_topk(
    dense_corpus, sp_ids, sp_weights, dense_q, sparse_q_dense, k: int, mask=None,
    dense_weight: float = 0.5, sparse_weight: float = 0.5, rrf_k: int = 60,
    block: int = 8192, dense_scale=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hybrid search over every row: the [B, N] dense scores and the exact
    forward-index scan of densified sparse queries [B, V], each top-``2k``,
    fused with weighted RRF → (fused scores [B, k], rows [B, k])."""
    fetch_k = min(2 * k, dense_corpus.shape[0])
    d_scores = dense_scores(dense_corpus, dense_q, dense_scale)
    if mask is not None:
        d_scores = torch.where(mask[None, :], d_scores, NEG_INF)
    d_top, d_rows = topk(d_scores, fetch_k)
    s_top, s_rows = sparse_topk(sp_ids, sp_weights, sparse_q_dense, fetch_k, mask, block=block)
    d_rows = torch.where(d_top > NEG_INF / 2, d_rows, -1)
    s_rows = torch.where(s_top > NEG_INF / 2, s_rows, -1)
    weights = _arm_weights((dense_weight, sparse_weight), d_rows.device)
    stacked = torch.stack([d_rows, s_rows])  # [2, B, fetch_k]
    return rrf_fuse_device(stacked, weights, k=min(k, fetch_k), rrf_k=rrf_k)
