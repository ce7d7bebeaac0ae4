"""Whole-candidate-section selection: every hybrid arm's scores reduced to
packed bucket tables in one kernel launch (port of
`verbatim_rag_tpu/ops/section.py`: the 2-way program, and the 3-way one with
the BM25 full-text sketches as a third arm).

For each arm and each block of ``block_cols`` corpus rows, table column
c = block·128 + lane holds the maximum over positions p of
``pack(score(row = block·block_cols + p·128 + lane), p) + mask_add[row]``:
the score's low 7 mantissa bits are overwritten with p, and the mask arrives
additive (0 keeps a score bit-exactly, -1e30 drowns it). One maximum gives
value and row; `table_topk` decodes only the selected entries. The [B, N]
score matrices never exist on the CUDA path.

Unlike the TPU kernel, which reads transposed [d, N] corpus copies (the MXU
wants the contraction dim on sublanes), the CUDA kernel reads the store's
row-major [N, d] rows, so no transposed copy is ever allocated; the tables
are the same.

:func:`section_tables_reference` is the plain PyTorch version (scores per
column block, pack, mask, a [B, P, 128] maximum), the CPU path and the
kernel's oracle; :func:`section_tables_cuda` launches
`csrc/section.cu::section_tables`, which replaces the TPU kernel
`_make_section_kernel`: int8 and bf16 arms on the wgmma walk, float32 arms on
the FMA walk, one launch for the arms of each row kind and layout
(:func:`plan_section_launches`). :func:`section_bucket_tables` dispatches on
the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .fused_topk import (
    BUCKET as LANE,
    NEG_INF,
    PLAIN_CHUNK_ROWS,
    _POS_BITS,
    _POS_MASK,
    KERNEL_KINDS,
    _aligned,
    _pack_pos,
    _positions,
    _ptr,
    block_scores,
    kernel_operands,
    prepare_queries,
    row_pitch_bytes,
    table_geometry,
    walk_streams,
)

#: Corpus rows per column block at the default (one winner per 64 rows).
BLOCK_COLS = 8192

#: Arms one launch takes (the 3-way section with BM25 uses all three).
MAX_ARMS = 3

#: Kernel launches since the last reset (the main path's proof of use), and
#: those of them with an int8 or bf16 arm whose query tile streams through
#: the wgmma walk's ring (rows past 2944 bytes, `walk_streams`).
launches = 0
launches_streamed = 0


def unpack_table(best: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(value with the low mantissa bits cleared, in-block position) from a
    packed table slice — applied to the selected top-k, not the table."""
    bits = best.contiguous().view(torch.int32)
    return (bits & ~_POS_MASK).view(torch.float32), bits & _POS_MASK


def _check_geometry(corpora, queries, scales, block_cols: int):
    n = corpora[0].shape[0]
    if n % block_cols:
        raise ValueError(f"corpus rows ({n}) must be a {block_cols}-multiple")
    if block_cols % LANE:
        raise ValueError(f"block_cols ({block_cols}) must be a multiple of {LANE}")
    if block_cols // LANE > (1 << _POS_BITS):
        raise ValueError(f"block_cols ({block_cols}) overflows the 7-bit pos pack")
    if len(queries) != len(corpora) or any(c.shape[0] != n for c in corpora):
        raise ValueError("one query matrix per arm, and every arm with the same rows")
    if not scales:
        scales = (None,) * len(corpora)
    for c, s in zip(corpora, scales):
        if c.dtype == torch.int8 and s is None:
            raise ValueError("int8 arm requires its per-row scale")
    return scales


def section_tables_reference(corpora, queries, mask, scales, block_cols: int):
    """Plain version: one packed table [B, N/block_cols·128] f32 per arm."""
    n = corpora[0].shape[0]
    p = block_cols // LANE
    pos = _positions(block_cols, corpora[0].device)
    mask_add = None if mask is None else torch.where(mask, 0.0, NEG_INF).float()
    step = max(PLAIN_CHUNK_ROWS // block_cols, 1) * block_cols
    tables = []
    for corpus, q, scale in zip(corpora, queries, scales):
        qp, q_scale = prepare_queries(q, corpus)
        c_scale = None if scale is None else scale.reshape(-1)
        b = qp.shape[0]
        parts = []
        for start in range(0, n, step):
            stop = min(n, start + step)
            s = block_scores(
                qp, q_scale, corpus[start:stop], None if c_scale is None else c_scale[start:stop]
            )
            packed = _pack_pos(s.reshape(b, -1, p, LANE), pos)
            if mask_add is not None:
                packed = packed + mask_add[start:stop].reshape(1, -1, p, LANE)
            best = torch.clamp(packed.amax(dim=2), min=NEG_INF)
            parts.append(best.reshape(b, -1))
        tables.append(torch.cat(parts, dim=1))
    return tuple(tables)


def plan_section_launches(arms) -> list[tuple]:
    """How `section_tables_cuda` launches arms of ``(dtype, row_bytes)``: one
    launch per row kind and, for int8 and bf16, per layout of the query tile
    (resident, or streamed past 2944 bytes: `walk_streams`), in the order of
    their first arm, as ``(dtype, arm indices, per-arm (queries, ring
    stages))``. A launch of int8 or bf16 arms runs the wgmma walk with each
    arm's `walk_geometry`; float32 arms run the FMA walk's 128-query tile
    (`table_geometry`)."""
    plan: dict = {}
    for i, (dtype, row_bytes) in enumerate(arms):
        geometry = table_geometry(dtype, row_bytes, "section")
        key = (dtype, dtype != torch.float32 and walk_streams(row_bytes))
        _, idx, geometries = plan.setdefault(key, (dtype, [], []))
        idx.append(i)
        geometries.append(geometry)
    return list(plan.values())


def section_tables_cuda(corpora, queries, mask, scales, block_cols: int):
    """Launch the CUDA kernels for all arms (one launch per row kind and
    layout, counted as one call): the plain version's tables."""
    global launches, launches_streamed
    n = corpora[0].shape[0]
    n_arms = len(corpora)
    if n_arms > MAX_ARMS:
        raise ValueError(f"at most {MAX_ARMS} arms per launch, got {n_arms}")
    tensors = [*corpora, *queries] + ([] if mask is None else [mask])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("section_tables_cuda needs CUDA tensors")
    arms = []
    for corpus, q, scale in zip(corpora, queries, scales):
        corpus, qp, q_scale, row_bytes = kernel_operands(corpus, q, "section")
        c_scale = None if scale is None else _aligned(scale.reshape(-1).float().contiguous())
        arms.append((corpus, qp, q_scale, c_scale, row_bytes))
    batch = queries[0].shape[0]
    width = (n // block_cols) * LANE
    tables = tuple(
        torch.empty((batch, width), dtype=torch.float32, device=corpora[0].device)
        for _ in range(n_arms)
    )
    if batch == 0 or n == 0:
        return tables
    mask_add = None if mask is None else torch.where(mask, 0.0, NEG_INF).float().contiguous()

    def pointers(values):
        return (ctypes.c_void_p * MAX_ARMS)(*values, *([None] * (MAX_ARMS - len(values))))

    def ints(values, kind=ctypes.c_int):
        return (kind * MAX_ARMS)(*values, *([0] * (MAX_ARMS - len(values))))

    fn = cuda_build.load("section").section_tables
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    stream = torch.cuda.current_stream(corpora[0].device).cuda_stream
    for dtype, idx, geometries in plan_section_launches([(a[0].dtype, a[4]) for a in arms]):
        group = [arms[i] for i in idx]
        with torch.cuda.device(corpora[0].device):
            rc = fn(
                len(group),
                pointers([a[1].data_ptr() for a in group]),
                pointers([a[0].data_ptr() for a in group]),
                pointers([_ptr(a[2]) for a in group]),
                pointers([_ptr(a[3]) for a in group]),
                pointers([tables[i].data_ptr() for i in idx]),
                ints([a[4] for a in group]),
                ints([row_pitch_bytes(a[1]) for a in group], ctypes.c_longlong),
                ints([row_pitch_bytes(a[0]) for a in group], ctypes.c_longlong),
                ints([g[0] for g in geometries]),
                ints([g[1] for g in geometries]),
                KERNEL_KINDS[dtype], _ptr(mask_add), batch, n, block_cols, stream,
            )
        cuda_build.check(rc, "section_tables")
    launches += 1
    if any(a[0].dtype != torch.float32 and walk_streams(a[4]) for a in arms):
        launches_streamed += 1
    return tables


def section_bucket_tables(corpora, queries, mask, scales=(), block_cols: int = BLOCK_COLS):
    """One packed bucket table [B, (N/block_cols)·128] f32 per arm.

    ``corpora``: per arm [N, d_a] rows (int8, bf16 or float32; any d_a: on
    CUDA rows whose starts are not a 16-byte multiple apart are copied to
    such a pitch once a call, `fused_topk.kernel_operands`);
    ``queries``: per arm [B, d_a] float32 (quantized per row on the fly for
    int8 arms, cast to the arm's dtype otherwise); ``mask``: [N] bool or None
    (every row live); ``scales``: per arm [N, 1] float32 for int8 arms, else
    None. A CPU tensor takes the plain version, a CUDA tensor the kernel (or
    a raise). Decode selected entries with `table_topk`.
    """
    scales = _check_geometry(corpora, queries, scales, block_cols)
    if corpora[0].device.type == "cpu":
        return section_tables_reference(corpora, queries, mask, scales, block_cols)
    return section_tables_cuda(corpora, queries, mask, scales, block_cols)


def table_topk(table, k: int, block_cols: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a packed table → (values [B, k] f32, global rows [B, k]
    int32; −1 where masked or absent). Selection is exact on the packed
    values, lowest column first among ties; only the k winners are decoded."""
    from .dense import topk

    k = min(k, table.shape[1])
    top_packed, cols = topk(table, k)
    vals, pos = unpack_table(top_packed)
    cols = cols.to(torch.int32)
    rows = (cols // LANE) * block_cols + pos * LANE + cols % LANE
    rows = torch.clamp(rows, max=n - 1)  # all-masked buckets decode junk pos
    return vals, torch.where(top_packed > NEG_INF / 2, rows, -1)


def _pad_cols(rows: torch.Tensor, width: int) -> torch.Tensor:
    if rows.shape[1] >= width:
        return rows
    pad = torch.full((rows.shape[0], width - rows.shape[1]), -1, dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, pad], dim=1)


def _section_projected_arm(
    table, sp_ids, sp_w, q_ids, q_w, fetch_k: int, depth: int, block_cols: int, n: int,
    rescore_impl: str,
) -> torch.Tensor:
    """Sketch arm after the tables: top-``depth`` table candidates → exact
    forward-index rescore → top-``fetch_k`` rows ([B, fetch_k] int32; −1
    pads). A zero exact score (no term overlap) is not a hit."""
    from .dense import topk
    from .hybrid import rescore_fn

    _, cand = table_topk(table, depth, block_cols, n)
    exact = rescore_fn(rescore_impl)(cand.contiguous(), sp_ids, sp_w, q_ids, q_w)
    r_top, r_pos = topk(exact, min(fetch_k, depth, exact.shape[1]))
    rows = torch.gather(cand, 1, r_pos)
    rows = torch.where(r_top > 0.0, rows, -1)
    return _pad_cols(rows, fetch_k)


def hybrid_section_topk(
    dense_corpus, sketch_corpus, sp_ids, sp_w, dense_q, sketch_q, q_ids, q_w,
    k: int, fetch_k: int, depth: int, mask=None,
    dense_weight: float = 0.5, sparse_weight: float = 0.5, rrf_k: int = 60,
    dense_scale=None, sketch_scale=None, rescore_impl: str = "pallas",
    block_cols: int = BLOCK_COLS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2-way hybrid query with the section tables as its candidate
    stage: one launch for both arms' tables, the table top-ks, the exact
    forward-index rescore and weighted RRF. Drop-in contract of
    `ops/hybrid.py::hybrid_fused_topk` on row-major corpora.

    Returns (fused RRF scores [B, k], rows [B, k]; −1 pads).
    """
    from .fusion import rrf_fuse_device

    n = dense_corpus.shape[0]
    scales = ()
    if dense_scale is not None or sketch_scale is not None:
        scales = (dense_scale, sketch_scale)
    td, ts = section_bucket_tables(
        (dense_corpus, sketch_corpus), (dense_q, sketch_q), mask, scales=scales,
        block_cols=block_cols,
    )
    _, d_rows = table_topk(td, fetch_k, block_cols, n)
    d_rows = _pad_cols(d_rows, fetch_k)
    s_rows = _section_projected_arm(
        ts, sp_ids, sp_w, q_ids, q_w, fetch_k, depth, block_cols, n, rescore_impl
    )
    from .hybrid import _arm_weights

    weights = _arm_weights((dense_weight, sparse_weight), d_rows.device)
    stacked = torch.stack([d_rows, s_rows])  # [2, B, fetch_k]
    return rrf_fuse_device(stacked, weights, k=min(k, fetch_k), rrf_k=rrf_k)


def hybrid_section_topk_3way(
    dense_corpus, sketch_corpus, sp_ids, sp_w, ft_sketch, ft_ids, ft_w,
    dense_q, sketch_q, q_ids, q_w, ft_q_proj, ft_q_ids, ft_q_w,
    k: int, fetch_k: int, depth: int, mask=None,
    dense_weight: float = 1.0, sparse_weight: float = 1.0, ft_weight: float = 1.0,
    rrf_k: int = 60, dense_scale=None, sketch_scale=None, ft_scale=None,
    rescore_impl: str = "pallas", block_cols: int = BLOCK_COLS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3-way hybrid (dense + SPLADE + BM25 full text) with the section
    tables as its candidate stage: one launch for the three arms' tables
    (the BM25 sketches read row-major like the others), then the table
    top-ks, the SPLADE and BM25 arms' exact rescores and 3-way weighted RRF.
    Drop-in contract of `ops/hybrid.py::hybrid_fused_topk_3way`.

    Returns (fused RRF scores [B, k], rows [B, k]; −1 pads).
    """
    from .fusion import rrf_fuse_device
    from .hybrid import _arm_weights

    n = dense_corpus.shape[0]
    scales = ()
    if any(s is not None for s in (dense_scale, sketch_scale, ft_scale)):
        scales = (dense_scale, sketch_scale, ft_scale)
    td, ts, tf = section_bucket_tables(
        (dense_corpus, sketch_corpus, ft_sketch), (dense_q, sketch_q, ft_q_proj), mask,
        scales=scales, block_cols=block_cols,
    )
    _, d_rows = table_topk(td, fetch_k, block_cols, n)
    d_rows = _pad_cols(d_rows, fetch_k)
    s_rows = _section_projected_arm(
        ts, sp_ids, sp_w, q_ids, q_w, fetch_k, depth, block_cols, n, rescore_impl
    )
    f_rows = _section_projected_arm(
        tf, ft_ids, ft_w, ft_q_ids, ft_q_w, fetch_k, depth, block_cols, n, rescore_impl
    )
    weights = _arm_weights((dense_weight, sparse_weight, ft_weight), d_rows.device)
    stacked = torch.stack([d_rows, s_rows, f_rows])  # [3, B, fetch_k]
    return rrf_fuse_device(stacked, weights, k=min(k, fetch_k), rrf_k=rrf_k)
