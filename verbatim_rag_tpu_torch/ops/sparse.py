"""Exact sparse retrieval over the padded forward index, and BM25's
document- and query-side weights (port of `verbatim_rag_tpu/ops/sparse.py`).

Each row of the forward index holds a document's terms as ``ids [N, m]`` and
``weights [N, m]`` (pad slots id 0, weight 0); a query batch is densified to
``[B, V]``, and ``score[b, n] = Σ_j weights[n, j] · q[b, ids[n, j]]``, a gather
from the query table and a weighted sum, taken block by block over the rows.
This scans every row, so the top-k is exact. BM25 rides the same scan: the
document side's saturated term frequencies are precomputed into the weights
(:func:`bm25_saturate`), the query side densifies ``idf`` per term.

Ordinary array math on the tensors' device; the JAX package has no Pallas
kernel here either.
"""

from __future__ import annotations

import torch

from .dense import NEG_INF, topk


def densify_queries(token_ids, values, vocab_size: int) -> torch.Tensor:
    """Scatter-add padded query terms ``[B, qm]`` into dense ``[B, V]``
    float32 rows (pad slots add 0 to column 0)."""
    batch = token_ids.shape[0]
    dense = torch.zeros((batch, vocab_size), dtype=torch.float32, device=token_ids.device)
    rows = torch.arange(batch, device=token_ids.device)[:, None].expand_as(token_ids)
    return dense.index_put_((rows, token_ids.long()), values.float(), accumulate=True)


def sparse_scores(token_ids, weights, q_dense, block: int = 8192) -> torch.Tensor:
    """Exact sparse scores [B, N] of every forward-index row.

    The scan gathers ``[B, block, m]`` query weights a block of rows at a
    time, which bounds its memory whatever N is.
    """
    n_rows = token_ids.shape[0]
    q = q_dense.float()
    scores = torch.empty((q.shape[0], n_rows), dtype=torch.float32, device=q.device)
    for start in range(0, n_rows, block):
        ids = token_ids[start : start + block].long()
        w = weights[start : start + block].float()
        scores[:, start : start + ids.shape[0]] = torch.einsum("bnm,nm->bn", q[:, ids], w)
    return scores


def sparse_topk(token_ids, weights, q_dense, k: int, mask=None, block: int = 8192):
    """Exact sparse top-k over `sparse_scores`: (scores [B, k], rows [B, k]);
    a row whose score is not above 0 (no term in common) is returned as −1,
    as an inverted index never surfaces a non-matching document."""
    scores = sparse_scores(token_ids, weights, q_dense, block)
    if mask is not None:
        scores = torch.where(mask[None, :], scores, NEG_INF)
    top, rows = topk(scores, k)
    return top, torch.where(top > 0.0, rows, -1)


def bm25_saturate(tf, doc_len, avgdl, k1: float = 1.2, b: float = 0.75) -> torch.Tensor:
    """Document-side BM25 saturation ``tf·(k1+1) / (tf + k1·(1−b+b·dl/avgdl))``
    of raw term frequencies [N, m] (0 in pad slots stays 0), float32."""
    tf = tf.float()
    norm = k1 * (1.0 - b + b * doc_len.float()[:, None] / avgdl)
    return tf * (k1 + 1.0) / (tf + norm)


def bm25_idf(doc_freq, n_docs) -> torch.Tensor:
    """Lucene-style BM25 idf ``ln(1 + (N − df + 0.5) / (df + 0.5))``, float32."""
    df = doc_freq.float()
    n = torch.as_tensor(n_docs, device=df.device).float()
    return torch.log1p((n - df + 0.5) / (df + 0.5))
