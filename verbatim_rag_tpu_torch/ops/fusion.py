"""Hybrid result fusion: weighted Reciprocal Rank Fusion (port of
`verbatim_rag_tpu/ops/fusion.py`).

score(id) = Σ_methods w_m / (rrf_k + rank_m(id) + 1); results ordered by
fused score, ties to the smaller id.

- :func:`rrf_merge_host` — host merge over hit dicts (``distance = 1 −
  fused score``), with :func:`sanitize_hybrid_weights` for user weights;
- :func:`rrf_fuse_np` — host fusion over candidate rows already on the host;
- :func:`rrf_fuse_device` — the same math on the tensors' device: sort by id
  (stable), segmented sum of each id's run, exact top-k.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from .dense import topk

logger = logging.getLogger(__name__)

ALLOWED_METHODS = {"dense", "sparse", "full_text"}


def sanitize_hybrid_weights(hybrid_weights: dict[str, float]) -> dict[str, float]:
    """Drop unknown methods and non-positive weights; error if nothing remains."""
    if not hybrid_weights:
        raise ValueError("hybrid_weights must be a non-empty dict")
    cleaned: dict[str, float] = {}
    for method, weight in hybrid_weights.items():
        if method not in ALLOWED_METHODS:
            logger.warning("Ignoring unsupported hybrid method %r", method)
            continue
        if not isinstance(weight, (int, float)) or weight <= 0:
            logger.warning("Ignoring non-positive weight for %r: %s", method, weight)
            continue
        cleaned[method] = float(weight)
    if not cleaned:
        raise ValueError("No valid hybrid_weights after validation")
    return cleaned


def normalize_weights(
    results_by_method: dict[str, list], weights: dict[str, float]
) -> dict[str, float]:
    """Restrict to available methods and normalize to sum 1 (equal if all zero)."""
    available = {m: weights.get(m, 0.0) for m in results_by_method}
    total = sum(available.values())
    if total == 0:
        logger.warning(
            "No non-zero weights for available methods; using equal weights for %s",
            list(results_by_method),
        )
        return {m: 1.0 / len(results_by_method) for m in results_by_method}
    return {m: w / total for m, w in available.items()}


def rrf_merge_host(
    results_by_method: dict[str, list[dict[str, Any]]],
    top_k: int,
    weights: dict[str, float],
    rrf_k: int = 60,
    log_label: str = "",
) -> list[dict[str, Any]]:
    """Weighted RRF over hit dicts ({'id': ..., ...}); returns merged hits with
    ``distance = 1 - fused_score``."""
    normalized = normalize_weights(results_by_method, weights)
    if log_label:
        logger.info(
            "Hybrid merge (%s): methods=%s weights=%s rrf_k=%s top_k=%s",
            log_label,
            list(results_by_method),
            normalized,
            rrf_k,
            top_k,
        )

    fused: dict[Any, float] = {}
    hit_by_id: dict[Any, dict] = {}
    for method, hits in results_by_method.items():
        weight = normalized.get(method, 0.0)
        for rank, hit in enumerate(hits):
            hit_id = hit.get("id")
            if hit_id is None:
                # `is None`, not falsy: integer row id 0 and empty-string
                # ids are legal and must participate in fusion.
                continue
            fused.setdefault(hit_id, 0.0)
            hit_by_id.setdefault(hit_id, hit)
            fused[hit_id] += weight / (rrf_k + rank + 1)

    ranked = sorted(fused, key=lambda hid: fused[hid], reverse=True)[:top_k]
    merged = []
    for hit_id in ranked:
        hit = dict(hit_by_id[hit_id])
        hit["distance"] = 1.0 - fused[hit_id]
        merged.append(hit)
    return merged


def rrf_fuse_np(
    method_indices, method_weights, k: int, rrf_k: int = 60
) -> tuple[np.ndarray, np.ndarray]:
    """Host RRF over per-method candidate rows [M, B, Km] (−1 = missing).

    :return: (fused scores [B, k], rows [B, k]; −1 pads)
    """
    n_methods, batch, km = method_indices.shape
    ranks = np.arange(km)[None, None, :]
    contrib = method_weights[:, None, None] / (rrf_k + ranks + 1.0)
    contrib = np.where(method_indices >= 0, contrib, 0.0)

    ids = np.moveaxis(method_indices, 0, 1).reshape(batch, -1)
    scores = np.moveaxis(contrib, 0, 1).reshape(batch, -1)

    out_scores = np.zeros((batch, k), np.float32)
    out_rows = np.full((batch, k), -1, np.int64)
    for b in range(batch):
        fused: dict[int, float] = {}
        for row, s in zip(ids[b], scores[b]):
            if row >= 0:
                fused[int(row)] = fused.get(int(row), 0.0) + float(s)
        ranked = sorted(fused.items(), key=lambda kv: -kv[1])[:k]
        for j, (row, s) in enumerate(ranked):
            out_rows[b, j] = row
            out_scores[b, j] = s
    return out_scores, out_rows


def _flatten_contrib(method_indices, method_weights, rrf_k):
    """[M, B, Km] → ([B, M·Km] ids, [B, M·Km] per-slot RRF contributions)."""
    n_methods, batch, km = method_indices.shape
    ranks = torch.arange(km, device=method_indices.device, dtype=torch.int32)
    ranks = ranks[None, None, :].expand(method_indices.shape)
    contrib = method_weights[:, None, None] / ((rrf_k + ranks) + 1.0)
    contrib = torch.where(method_indices >= 0, contrib, 0.0)
    total = n_methods * km
    ids = method_indices.movedim(0, 1).reshape(batch, total)
    scores = contrib.movedim(0, 1).reshape(batch, total)
    return ids, scores


def rrf_fuse_device(
    method_indices: torch.Tensor,  # [M, B, Km] row indices per method (−1 = no hit)
    method_weights: torch.Tensor,  # [M] normalized weights (float32)
    k: int,
    rrf_k: int = 60,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse M ranked candidate lists on the tensors' device.

    An id appears at most once per method, so after the stable sort by id a
    run of equal ids has at most M elements: the segmented sum is M−1
    shifted masked adds, and each run's score lands on its last slot.

    :return: (fused scores [B, k], row indices [B, k]); slots without a
        candidate carry index −1 and score 0.
    """
    n_methods, batch, _ = method_indices.shape
    ids, scores = _flatten_contrib(method_indices, method_weights, rrf_k)

    order = torch.argsort(ids, dim=1, stable=True)
    ids_sorted = torch.gather(ids, 1, order)
    scores_sorted = torch.gather(scores, 1, order)

    def shifted(x, j, fill):
        pad = torch.full((batch, j), fill, dtype=x.dtype, device=x.device)
        return torch.cat([pad, x[:, :-j]], dim=1)

    fused = scores_sorted
    for j in range(1, n_methods):
        same = ids_sorted == shifted(ids_sorted, j, -2)
        fused = fused + torch.where(same, shifted(scores_sorted, j, 0.0), 0.0)

    run_end = torch.cat(
        [
            ids_sorted[:, 1:] != ids_sorted[:, :-1],
            torch.ones((batch, 1), dtype=torch.bool, device=ids.device),
        ],
        dim=1,
    )
    fused_scores = torch.where(run_end & (ids_sorted >= 0), fused, float("-inf"))
    top_scores, top_pos = topk(fused_scores, k)
    top_ids = torch.gather(ids_sorted, 1, top_pos)
    top_ids = torch.where(top_scores > float("-inf"), top_ids, -1)
    top_scores = torch.where(top_ids >= 0, top_scores, 0.0)
    return top_scores, top_ids
