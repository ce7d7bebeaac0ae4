"""Projection-accelerated sparse retrieval (port of
`verbatim_rag_tpu/ops/sparse_projected.py`).

A fixed random signed projection ``P [V, d_p]`` maps sparse vectors to dense
sketches; candidate generation is then a dense sketch matmul, and the top
candidates are rescored exactly from the forward index (`ops/rescore.py`).

:func:`projection_matrix`, :func:`project_queries` and
:func:`project_sparse_queries` are host-side numpy copies (the same SFC64
stream, bit-equal to the JAX package's); :func:`exact_rescore` is the host
rescore of candidate rows against dense query rows, in numpy.
:func:`project_rows` and :func:`project_query_arrays` run on the tensors'
device as a gather plus a weighted sum.
"""

from __future__ import annotations

import numpy as np
import torch

#: Elements of the [rows, m, d_p] block :func:`project_rows` gathers at a
#: time (4096 rows of 128 slots at d_p = 768: 1.6 GB of float32).
PROJECT_CHUNK_ELEMENTS = 4096 * 128 * 768


def projection_matrix(vocab_size: int, d_p: int, seed: int = 0) -> np.ndarray:
    """Deterministic ±1/√d_p signed projection [V, d_p] (float32)."""
    rng = np.random.Generator(np.random.SFC64(seed))
    r = rng.random((vocab_size, d_p), dtype=np.float32)
    np.subtract(r, np.float32(0.5), out=r)
    np.copysign(np.float32(1.0 / np.sqrt(d_p)), r, out=r)
    return r


def project_rows(token_ids, weights, projection) -> torch.Tensor:
    """Sketch forward-index rows: out[n] = Σ_j w[n,j] · P[ids[n,j]].

    All three are tensors on one device; rows are sketched in chunks of at
    most :data:`PROJECT_CHUNK_ELEMENTS` gathered values. Pad slots
    contribute 0 (weight 0).
    """
    n, m = token_ids.shape
    out = torch.empty((n, projection.shape[1]), dtype=torch.float32, device=projection.device)
    step = max(1, PROJECT_CHUNK_ELEMENTS // max(m * projection.shape[1], 1))
    for start in range(0, n, step):
        ids = token_ids[start : start + step].long()
        w = weights[start : start + step].float()
        gathered = projection[ids]  # [rows, m, d_p]
        out[start : start + ids.shape[0]] = torch.einsum("nmd,nm->nd", gathered, w)
    return out


def project_queries(q_dense: np.ndarray, projection: np.ndarray) -> np.ndarray:
    """Query sketches [B, d_p] from dense query vectors [B, V] (host)."""
    return (q_dense @ projection).astype(np.float32)


def project_sparse_queries(
    sparse_rows: list[dict[int, float]], projection: np.ndarray
) -> np.ndarray:
    """Query sketches [B, d_p] straight from sparse dicts (host)."""
    d_p = projection.shape[1]
    out = np.zeros((len(sparse_rows), d_p), np.float32)
    for i, row in enumerate(sparse_rows):
        for t, w in row.items():
            t = int(t)
            if 0 <= t < projection.shape[0]:
                out[i] += float(w) * projection[t]
    return out


def project_query_arrays(q_ids, q_w, projection_dev) -> torch.Tensor:
    """Query sketches [B, d_p] from padded id/weight tensors, on their device.

    Pad slots (id 0, weight 0) gather row 0 but contribute nothing.
    """
    gathered = projection_dev[q_ids.long()]  # [B, m, d_p]
    return torch.einsum("bmd,bm->bd", gathered, q_w.float())


def exact_rescore(
    candidate_rows: np.ndarray,  # [B, C] row indices (may contain -1)
    sp_ids: np.ndarray,  # [N, m] host forward index
    sp_weights: np.ndarray,  # [N, m]
    q_dense: np.ndarray,  # [B, V]
) -> np.ndarray:
    """Exact sparse scores [B, C] float32 of each (query, candidate) on the
    host: ``Σ_j w[row, j] · q[b, ids[row, j]]``, −inf where the row is < 0.
    Each score sums its row's slots in order in float32, as the JAX
    package's C++ rescore does."""
    batch, c = candidate_rows.shape
    safe_rows = np.clip(candidate_rows, 0, sp_ids.shape[0] - 1)
    ids = sp_ids[safe_rows]  # [B, C, m]
    weights = sp_weights[safe_rows].astype(np.float32)
    q_vals = np.asarray(q_dense, np.float32)[np.arange(batch)[:, None, None], ids]
    scores = np.zeros((batch, c), np.float32)
    for j in range(ids.shape[2]):
        w = weights[:, :, j]
        scores += np.where(w != 0.0, w * q_vals[:, :, j], np.float32(0.0))
    return np.where(candidate_rows >= 0, scores, -np.inf).astype(np.float32)
