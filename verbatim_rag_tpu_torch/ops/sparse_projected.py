"""Projection-accelerated sparse retrieval (port of
`verbatim_rag_tpu/ops/sparse_projected.py`).

A fixed random signed projection ``P [V, d_p]`` maps sparse vectors to dense
sketches; candidate generation is then a dense sketch matmul, and the top
candidates are rescored exactly from the forward index (`ops/rescore.py`).

:func:`projection_matrix` and :func:`project_sparse_queries` are host-side
numpy copies (the same SFC64 stream, bit-equal to the JAX package's).
:func:`project_rows` and :func:`project_query_arrays` run on the tensors'
device as a gather plus a weighted sum.
"""

from __future__ import annotations

import numpy as np
import torch

#: Rows sketched per gather in :func:`project_rows`: bounds the [rows, m, d_p]
#: gathered block (4096·128·768·4 B = 1.6 GB at the serving shape).
PROJECT_CHUNK_ROWS = 4096


def projection_matrix(vocab_size: int, d_p: int, seed: int = 0) -> np.ndarray:
    """Deterministic ±1/√d_p signed projection [V, d_p] (float32)."""
    rng = np.random.Generator(np.random.SFC64(seed))
    r = rng.random((vocab_size, d_p), dtype=np.float32)
    np.subtract(r, np.float32(0.5), out=r)
    np.copysign(np.float32(1.0 / np.sqrt(d_p)), r, out=r)
    return r


def project_rows(token_ids, weights, projection) -> torch.Tensor:
    """Sketch forward-index rows: out[n] = Σ_j w[n,j] · P[ids[n,j]].

    All three are tensors on one device; rows are sketched in chunks of
    :data:`PROJECT_CHUNK_ROWS`. Pad slots contribute 0 (weight 0).
    """
    n = token_ids.shape[0]
    out = torch.empty((n, projection.shape[1]), dtype=torch.float32, device=projection.device)
    for start in range(0, n, PROJECT_CHUNK_ROWS):
        ids = token_ids[start : start + PROJECT_CHUNK_ROWS].long()
        w = weights[start : start + PROJECT_CHUNK_ROWS].float()
        gathered = projection[ids]  # [rows, m, d_p]
        out[start : start + ids.shape[0]] = torch.einsum("nmd,nm->nd", gathered, w)
    return out


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
