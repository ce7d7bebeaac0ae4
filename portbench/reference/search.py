"""Hybrid retrieval, written from the store's description: a dense arm
(cosine of L2-normalised rows, top ``2k``), a sparse arm (sketch candidates
by a signed random projection of the forward index, their exact
term-overlap scores, top ``2k`` with a positive score) and weighted
reciprocal rank fusion (``w / (rrf_k + rank + 1)``; ties to the smaller row).
Selection orders equal values lowest index first.

Arithmetic is float32. The rows and sketches the store holds, and the
queries it scores against them, are rounded to the configuration's storage
type first (``storage="bfloat16"``: the bf16 store), so the reference ranks
what the configuration stores; ``storage="fp8"`` (float8 e4m3, one scale a
row) is one precision below it. Plain torch and numpy: nothing of the
measured program."""

from __future__ import annotations

import numpy as np
import torch


def projection(vocab: int, dim: int, seed: int = 0) -> np.ndarray:
    """The ±1/√dim sign projection [vocab, dim] the store derives from its
    ``projection_seed``: the signs of an SFC64 stream's uniforms less 0.5."""
    rng = np.random.Generator(np.random.SFC64(seed))
    r = rng.random((vocab, dim), dtype=np.float32) - np.float32(0.5)
    return np.copysign(np.float32(1.0 / np.sqrt(dim)), r).astype(np.float32)


def ordered_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of the last axis, value descending, lowest index first
    among equal values."""
    vals, pos = torch.topk(scores, k, dim=-1)
    order = torch.argsort(pos, dim=-1)
    vals, pos = vals.gather(-1, order), pos.gather(-1, order)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)
    return vals.gather(-1, order), pos.gather(-1, order)


def stored(x: torch.Tensor, storage: str) -> torch.Tensor:
    """Rows as the store holds them, back in float32."""
    if storage == "bfloat16":
        return x.to(torch.bfloat16).float()
    if storage == "fp8":
        scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x


def sketch(ids: torch.Tensor, w: torch.Tensor, proj: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    out = torch.empty((ids.shape[0], proj.shape[1]), dtype=torch.float32, device=proj.device)
    for s in range(0, ids.shape[0], chunk):
        out[s : s + chunk] = torch.einsum("nmd,nm->nd", proj[ids[s : s + chunk].long()], w[s : s + chunk].float())
    return out


class HybridReference:
    """The corpus side: rows [N, d], forward index ids / weights [N, m]."""

    def __init__(self, dense, sp_ids, sp_w, vocab: int, proj_dim: int = 768, proj_seed: int = 0,
                 storage: str = "bfloat16"):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.storage = storage
        dense = dense.float()
        self.dense = stored(dense / dense.norm(dim=1, keepdim=True).clamp(min=1e-30), storage)
        self.sp_ids, self.sp_w = sp_ids.long(), sp_w.float()
        self.proj = torch.from_numpy(projection(vocab, proj_dim, proj_seed)).to(dense.device)
        self.sketch = stored(sketch(self.sp_ids, self.sp_w, self.proj), storage)

    def _rescore(self, cand, q_ids, q_w):
        ids, w = self.sp_ids[cand], self.sp_w[cand]  # [B, C, m]
        score = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
        for t in range(q_ids.shape[1]):
            hit = (ids == q_ids[:, t, None, None]) * w
            score += q_w[:, t, None] * hit.sum(-1)
        return score

    def search(self, q_dense, q_ids, q_w, k: int, depth: int = 256, rrf_k: int = 60,
               weights=(0.5, 0.5)) -> tuple[np.ndarray, np.ndarray]:
        """(fused scores [B, k], rows [B, k]; −1 where fewer hits)."""
        n = self.dense.shape[0]
        fetch = min(2 * k, n)
        q = q_dense.float()
        q = stored(q / q.norm(dim=1, keepdim=True).clamp(min=1e-12), self.storage)
        _, d_rows = ordered_topk(q @ self.dense.t(), fetch)
        q_ids, q_w = q_ids.long(), q_w.float()
        q_sketch = stored(torch.einsum("bmd,bm->bd", self.proj[q_ids], q_w), self.storage)
        _, cand = ordered_topk(q_sketch @ self.sketch.t(), min(max(depth, fetch), n))
        exact = self._rescore(cand, q_ids, q_w)
        s_top, s_pos = ordered_topk(exact, fetch)
        s_rows = torch.where(s_top > 0, cand.gather(1, s_pos), -1)
        return rrf(torch.stack([d_rows, s_rows]).cpu().numpy(), weights, k, rrf_k)


def rrf(arms: np.ndarray, weights, k: int, rrf_k: int = 60) -> tuple[np.ndarray, np.ndarray]:
    """Weighted reciprocal rank fusion of ranked rows [M, B, K] (−1 = none)."""
    w = np.asarray(weights, np.float32) / np.float32(sum(weights))
    n_arms, batch, depth = arms.shape
    contrib = w[:, None] / (np.float32(rrf_k) + np.arange(depth, dtype=np.float32) + np.float32(1))
    scores = np.zeros((batch, k), np.float32)
    rows = np.full((batch, k), -1, np.int64)
    for b in range(batch):
        fused: dict[int, np.float32] = {}
        for m in range(n_arms):
            for r, row in enumerate(arms[m, b]):
                if row >= 0:
                    fused[int(row)] = fused.get(int(row), np.float32(0)) + contrib[m, r]
        ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        for j, (row, s) in enumerate(ranked):
            rows[b, j], scores[b, j] = row, s
    return scores, rows
