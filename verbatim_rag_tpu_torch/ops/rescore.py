"""Exact sparse rescore: CUDA kernel with the row gather fused in, plus its
plain PyTorch twin.

Port of `verbatim_rag_tpu/ops/rescore.py`. :func:`exact_rescore_oneshot` is
the plain version (one broadcast compare-select-reduce over
[B, C, m, qm]); :func:`exact_rescore_cuda` launches `csrc/rescore.cu`, which
replaces the TPU kernel `_rescore_kernel` and reads candidate rows straight
from the [N, m] forward index, looking each slot up in a shared-memory hash
table of the query's terms. :func:`exact_rescore_dispatch` is the store's
"pallas" rescore impl: the plain version for CPU tensors, the kernel for
CUDA tensors, for any m, qm and batch (past the grid's 65,535 rows on y the
kernel runs once a slice of queries, `cuda_build.grid_chunks`).

The forward index holds int32 or int16 ids and float32 or float16 weights
(the store's ``sparse_ids_dtype`` / ``sparse_weight_dtype``). Both versions
widen the gathered slots to int32 / float32 before the compare-multiply, as
the JAX path does; queries are int32 / float32.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NEG_INF = -1e30

#: Forward-index slot types the kernel reads: bytes of an id, of a weight.
_ID_BYTES = {torch.int32: 4, torch.int16: 2}
_WEIGHT_BYTES = {torch.float32: 4, torch.float16: 2}

#: Kernel launches since the last reset (the main path's proof of use).
launches = 0


def _gather_rows(cand_rows, sp_ids, sp_w):
    safe = cand_rows.clamp(min=0).reshape(-1)
    m = sp_ids.shape[1]
    cand_ids = sp_ids.index_select(0, safe).reshape(*cand_rows.shape, m).to(torch.int32)
    cand_w = sp_w.index_select(0, safe).reshape(*cand_rows.shape, m)
    return cand_ids, cand_w


def exact_rescore_oneshot(cand_rows, sp_ids, sp_w, q_ids, q_w):
    """Plain version: exact sparse scores [B, C] f32; rows < 0 → -1e30."""
    cand_ids, cand_w = _gather_rows(cand_rows, sp_ids, sp_w)
    match = cand_ids[..., None] == q_ids.to(torch.int32)[:, None, None, :]
    contrib = torch.where(
        match, cand_w[..., None].float() * q_w.float()[:, None, None, :], 0.0
    )
    scores = contrib.sum(dim=(-1, -2))
    return torch.where(cand_rows >= 0, scores, NEG_INF)


def exact_rescore_cuda(cand_rows, sp_ids, sp_w, q_ids, q_w):
    """Launch the CUDA kernel: [B, C] f32 scores, -1e30 for rows < 0 or ≥ N."""
    global launches
    tensors = (cand_rows, sp_ids, sp_w, q_ids, q_w)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("exact_rescore_cuda needs CUDA tensors")
    if sp_ids.dtype not in _ID_BYTES or sp_w.dtype not in _WEIGHT_BYTES:
        raise TypeError(
            "the rescore kernel reads int32 or int16 ids and float32 or float16 "
            f"weights, got {sp_ids.dtype}/{sp_w.dtype}"
        )
    if cand_rows.dtype != torch.int32 or q_ids.dtype != torch.int32 or q_w.dtype != torch.float32:
        raise TypeError(
            f"cand_rows/q_ids must be int32 and q_w float32, got "
            f"{cand_rows.dtype}/{q_ids.dtype}/{q_w.dtype}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rescore inputs must be contiguous")
    batch, cands = cand_rows.shape
    n_rows, m = sp_ids.shape
    qm = q_ids.shape[1]
    if sp_w.shape != (n_rows, m) or q_ids.shape != (batch, qm) or q_w.shape != (batch, qm):
        raise ValueError(
            f"shape mismatch: cand {tuple(cand_rows.shape)}, sp_ids {tuple(sp_ids.shape)}, "
            f"sp_w {tuple(sp_w.shape)}, q_ids {tuple(q_ids.shape)}, q_w {tuple(q_w.shape)}"
        )
    out = torch.empty((batch, cands), dtype=torch.float32, device=cand_rows.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load("rescore")
    fn = lib.sparse_rescore
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    # The kernel's grid holds the batch on y: one launch per slice of
    # queries that fits it.
    for b0, b1 in cuda_build.grid_chunks(batch):
        with torch.cuda.device(cand_rows.device):
            rc = fn(
                cand_rows[b0:b1].data_ptr(), sp_ids.data_ptr(), sp_w.data_ptr(),
                q_ids[b0:b1].data_ptr(), q_w[b0:b1].data_ptr(), out[b0:b1].data_ptr(),
                b1 - b0, cands, n_rows, m, qm, _ID_BYTES[sp_ids.dtype], _WEIGHT_BYTES[sp_w.dtype],
                torch.cuda.current_stream(cand_rows.device).cuda_stream,
            )
        cuda_build.check(rc, "sparse_rescore")
        launches += 1
    return out


def exact_rescore_dispatch(cand_rows, sp_ids, sp_w, q_ids, q_w):
    """The store's "pallas" impl: plain version on CPU tensors, kernel on CUDA."""
    if cand_rows.device.type == "cpu":
        return exact_rescore_oneshot(cand_rows, sp_ids, sp_w, q_ids, q_w)
    return exact_rescore_cuda(cand_rows, sp_ids, sp_w, q_ids, q_w)
