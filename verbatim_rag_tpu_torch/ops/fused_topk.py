"""Fused matmul + bucket-max candidate selection (port of
`verbatim_rag_tpu/ops/fused_topk.py`: the v1 and v2 kernels).

**v1** (:func:`matmul_bucket_max`, :func:`fused_candidate_topk`): bucket g
holds the 128 consecutive rows ``g·128 … g·128 + 127``; the table is each
bucket's maximum score [B, N/128] float32 and the global row of the highest
lane that holds it [B, N/128] int32. Masked rows score exactly -1e30 (a
select), so an all-masked bucket reports -1e30 at row ``g·128 + 127``. N must
be a 128-multiple, and either ≤ 16384 or a 16384-multiple, as in JAX.
Queries are cast to the corpus dtype (bf16 or float32); an int8 corpus has no
scale in v1 and is refused. :func:`matmul_bucket_max_reference` is the plain
version and oracle, :func:`matmul_bucket_max_cuda` launches
`csrc/section.cu::bucket_max_v1`, which replaces the TPU kernel
`_bucket_max_kernel`.

**v2**: for a corpus of N rows cut into blocks of ``block_rows`` (`choose_block_rows`),
bucket g = block·128 + lane holds the block_rows/128 rows
``{block·block_rows + pos·128 + lane}``. Each score's low 7 mantissa bits are
overwritten with its ``pos`` before the per-bucket maximum, so one maximum
gives the winning value and, in its low bits, the winning row. Masked rows
are replaced by -1e30 (a select, not an add). Only the [B, N/block_rows·128]
table of (value with the low bits cleared, global row) is written; the
[B, N] score matrix never exists on the CUDA path.

:func:`matmul_bucket_max_v2_reference` is the plain PyTorch version (scores
per block, pack, select, a [B, P, 128] maximum), the CPU path and the
kernel's oracle. :func:`matmul_bucket_max_v2_cuda` launches
`csrc/section.cu::bucket_max_v2`, which replaces the TPU kernels
`_bucket_max_v2_onedot_kernel` and `_bucket_max_v2_chunked_kernel`. The two
TPU variants compute the same function and are both served by the one CUDA
kernel; :func:`matmul_bucket_max_v2` dispatches on the tensors' device.

The kernels read int8 (v2 only), bf16 or float32 rows of any width whose
starts lie a 16-byte multiple apart (`check_kernel_rows`): TMA takes such a
row stride, and fills the bytes past a row's end with zeros. The store keeps
its rows at that pitch (`pitched_zeros`); a caller's packed rows of another
width are copied to it once a call (`pitched`). int8 and bf16 rows run on
the wgmma walk of `csrc/section.cu` (one main loop for section, v2 and v1,
each with its epilogue) with the query tile and ring depth of
:func:`walk_geometry`; rows past 2944 bytes stream their query tile through
the ring
(:func:`walk_streams`). float32 rows run on the FMA walk (128-query tiles,
queries and rows streamed by TMA; :func:`table_geometry`).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NEG_INF = -1e30

BUCKET = 128  # lane width: one winner per bucket
BLOCK_ROWS = 16384  # largest corpus block
MIN_BLOCK_ROWS = 2048  # smallest corpus block for corpora above BLOCK_ROWS

_POS_BITS = 7  # low mantissa bits carrying the in-bucket position
_POS_MASK = (1 << _POS_BITS) - 1  # 0x7F

#: Corpus rows scored per step of the plain versions: bounds the [B, rows]
#: float32 temporaries (512 · 131072 · 4 B = 268 MB at the serving batch).
PLAIN_CHUNK_ROWS = 131072

#: Kernel launches since the last reset (the main path's proof of use):
#: bucket_max_v2, and bucket_max_v1.
launches = 0
launches_v1 = 0

#: Row pitch of the table kernels' operands: TMA reads rows whose starts lie
#: a multiple of 16 bytes apart. A row itself may be of any width.
ROW_ALIGN = 16

#: Corpora the kernel wrappers (section, v2, v1) copied to a 16-byte pitch
#: since the last reset: a caller's packed rows of another width. The
#: store's rows are kept at that pitch and are never copied.
corpus_copies = 0


def choose_block_rows(n: int) -> int | None:
    """Largest kernel block size that tiles ``n`` corpus rows, or None.

    ``n`` itself when it is a 128-multiple ≤ 16384; otherwise the largest of
    16384, 8192, 4096, 2048 that divides it (at most 128 positions a bucket,
    so the position always fits the 7-bit pack)."""
    if n % BUCKET != 0:
        return None
    if n <= BLOCK_ROWS:
        return n
    bl = BLOCK_ROWS
    while bl >= MIN_BLOCK_ROWS:
        if n % bl == 0:
            return bl
        bl //= 2
    return None


def bucket_table_width(n: int) -> int | None:
    """Columns of the (value, row) bucket table for ``n`` rows — the most
    candidates the kernel can supply — or None if the geometry is
    unsupported."""
    block_rows = choose_block_rows(n)
    if block_rows is None:
        return None
    return (n // block_rows) * BUCKET


def _pack_pos(scores: torch.Tensor, pos) -> torch.Tensor:
    """Overwrite the low 7 mantissa bits of float32 ``scores`` with ``pos``
    (monotone within 127 ulp for same-sign values)."""
    bits = scores.contiguous().view(torch.int32)
    return ((bits & ~_POS_MASK) | pos).view(torch.float32)


def _unpack(best: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(value with the low bits cleared, pos) from a packed float32 tensor."""
    bits = best.contiguous().view(torch.int32)
    return (bits & ~_POS_MASK).view(torch.float32), bits & _POS_MASK


def prepare_queries(q, corpus):
    """Queries as the kernels take them: int8 codes and float32 [B] scales
    for an int8 corpus, else the corpus dtype and no scale."""
    if corpus.dtype == torch.int8:
        from .dense import quantize_queries_int8

        qi, q_scale = quantize_queries_int8(q)
        return qi.contiguous(), q_scale.reshape(-1).contiguous()
    return q.to(corpus.dtype).contiguous(), None


def block_scores(q, q_scale, rows, row_scale) -> torch.Tensor:
    """Scores [B, r] of prepared queries against corpus ``rows`` [r, d] in the
    kernels' order: ``(raw * q_scale) * row_scale`` for int8 codes (exact
    int32 dots), a float32 product otherwise."""
    from .dense import int8_dots, matmul_f32

    if rows.dtype == torch.int8:
        return int8_dots(q, rows) * q_scale[:, None] * row_scale.reshape(1, -1)
    return matmul_f32(q, rows.t())


def _positions(block_rows: int, device) -> torch.Tensor:
    return torch.arange(block_rows // BUCKET, dtype=torch.int32, device=device)[None, None, :, None]


#: Row kinds of `csrc/section.cu`.
KERNEL_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}

#: Shared memory a CTA of `csrc/section.cu` may use.
_SMEM_LIMIT = 232448

#: The FMA walk (`fma_walk_kernel`, float32 rows): 128 queries a CTA and a
#: ring of its own depth (4 stages of 32 KB: 128 rows and 128 queries × 32
#: floats, both streamed), so its shared memory is one size a mode, whatever
#: the row width: the ring, the running maxima of section and v2 (128 × 128
#: float32; v1 keeps none), the mbarriers and 1024 bytes of alignment slack.
#: Mirrors `fma_smem_bytes`.
FMA_QUERIES = 128
_FMA_SMEM_V1 = 4 * 2 * 128 * 128 + 2 * 4 * 8 + 1024
_FMA_SMEM = {"section": _FMA_SMEM_V1 + 128 * 128 * 4, "v2": _FMA_SMEM_V1 + 128 * 128 * 4, "v1": _FMA_SMEM_V1}

#: The wgmma walk (`table_walk`) in one of two layouts. Resident (rows of
#: up to `_WALK_RESIDENT_CHUNKS` chunks, 2944 bytes): the query tile as
#: 128-byte chunks of [queries][128 B] beside a ring of 16 KB stages (128
#: rows × 128 bytes). Streamed (wider rows): no resident tile; each stage
#: holds a chunk of the rows and the same chunk of the queries (16 KB +
#: queries × 128 B). Then 4 side slots, the mbarriers and 1024 bytes of
#: alignment slack. Mirrors `walk_smem_bytes`. A side slot holds c_scale
#: [128] float32, then the mask: its bytes for v2 and v1 (`kSideBytesV2`),
#: mask_add [128] float32 for section (`kSideBytesSection`). The keys are the
#: walk's epilogues (`mode`).
_WALK_STAGE_BYTES = 128 * 128
_WALK_RESIDENT_CHUNKS = 23
_WALK_SIDE_SLOTS = 4
_WALK_SIDE_BYTES = {"section": 128 * 4 + 128 * 4, "v2": 128 * 4 + 128, "v1": 128 * 4 + 128}
_WALK_MIN_STAGES, _WALK_TILE_STAGES, _WALK_MAX_STAGES = 2, 4, 8


def walk_streams(row_bytes: int) -> bool:
    """Whether the wgmma walk streams the query tile through its ring (rows
    wider than 2944 bytes) instead of keeping it resident. Mirrors
    `walk_streams` in `csrc/section.cu`."""
    return -(-row_bytes // 128) > _WALK_RESIDENT_CHUNKS


def _walk_smem(queries: int, row_bytes: int, stages: int, mode: str = "v2") -> int:
    chunks = -(-row_bytes // 128)
    side = _WALK_SIDE_SLOTS * _WALK_SIDE_BYTES[mode]
    barriers = (1 + 2 * stages + 2 * _WALK_SIDE_SLOTS) * 8
    if walk_streams(row_bytes):
        return stages * (_WALK_STAGE_BYTES + queries * 128) + side + barriers + 1024
    return chunks * queries * 128 + stages * _WALK_STAGE_BYTES + side + barriers + 1024


def walk_geometry(row_bytes: int, mode: str = "v2") -> tuple[int, int]:
    """(queries a CTA, ring stages) of the wgmma walk for int8 or bf16 rows
    of ``row_bytes`` under epilogue ``mode``: 128 queries (two warpgroups of
    64) when their tile fits beside a 4-deep ring (resident up to 1152
    bytes a row: int8 d ≤ 1152, bf16 d ≤ 576; and every streamed row, past
    2944 bytes, whose stages carry the queries: 32 KB a stage), else 64 (one
    warpgroup); then the deepest ring up to 8 stages that fits (6 for a
    streamed tile). Every 16-byte-multiple row gets at least 2 stages."""
    fits = _walk_smem(128, row_bytes, _WALK_TILE_STAGES, mode) <= _SMEM_LIMIT
    queries = 128 if fits else 64
    stages = _WALK_MAX_STAGES
    while stages >= _WALK_MIN_STAGES and _walk_smem(queries, row_bytes, stages, mode) > _SMEM_LIMIT:
        stages -= 1
    return queries, stages


def table_geometry(dtype, row_bytes: int, mode: str = "v2") -> tuple[int, int]:
    """(queries a CTA, ring stages) of the walk that takes rows of ``dtype``:
    `walk_geometry` for int8 and bf16; for float32 rows the FMA walk's
    128-query tile, whatever their width (the queries stream beside the
    rows), and 0 stages: its ring depth is the kernel's own."""
    if dtype == torch.float32:
        return FMA_QUERIES, 0
    return walk_geometry(row_bytes, mode)


def tile_queries(dtype, row_bytes: int, mode: str = "v2") -> int:
    """Queries per CTA (`table_geometry`)."""
    return table_geometry(dtype, row_bytes, mode)[0]


def pitch_columns(cols: int, element_size: int) -> int:
    """Columns of a row buffer that holds ``cols`` values of
    ``element_size`` bytes at a pitch rounded up to 16 bytes."""
    step = ROW_ALIGN // element_size
    return -(-cols // step) * step


def pitched_zeros(rows: int, cols: int, dtype, device=None) -> torch.Tensor:
    """[rows, cols] zeros whose rows start a 16-byte multiple apart: the
    [rows, cols] view of a [rows, `pitch_columns`] buffer (the buffer itself
    when the width is already a 16-byte multiple). The table kernels read it
    in place, as cuBLAS and every torch op do."""
    pitch = pitch_columns(cols, torch.empty((), dtype=dtype).element_size())
    buf = torch.zeros((rows, pitch), dtype=dtype, device=device)
    return buf if pitch == cols else buf[:, :cols]


def row_pitch_bytes(t: torch.Tensor) -> int:
    """Bytes between the starts of two rows of a [n, d] tensor."""
    return t.stride(0) * t.element_size()


def is_pitched(t: torch.Tensor) -> bool:
    """Whether the table kernels read the rows of a [n, d] tensor in place:
    unit column stride, rows a 16-byte multiple apart (and not overlapping),
    a 16-byte aligned base."""
    pitch = row_pitch_bytes(t)
    return (
        t.dim() == 2
        and (t.shape[1] <= 1 or t.stride(1) == 1)
        and pitch % ROW_ALIGN == 0
        and pitch >= t.shape[1] * t.element_size()
        and t.data_ptr() % ROW_ALIGN == 0
    )


def pitched(t: torch.Tensor) -> torch.Tensor:
    """``t`` when the kernels read it in place (`is_pitched`), else a copy
    at a 16-byte pitch."""
    if is_pitched(t):
        return t
    out = pitched_zeros(t.shape[0], t.shape[1], t.dtype, t.device)
    out.copy_(t)
    return out


def resident_bytes(t) -> int:
    """Device bytes a [n, ...] array holds: its rows at their pitch (a
    pitched view counts its buffer's padding, ``nbytes`` does not); a
    row-sharded array (`parallel.mesh.RowSharded`) its shards'."""
    shards = getattr(t, "shards", None)
    if shards is not None:
        return sum(resident_bytes(s) for s in shards)
    if t.dim() >= 2 and t.shape[0]:
        return t.shape[0] * row_pitch_bytes(t)
    return t.numel() * t.element_size()


def _check_kind(corpus, what: str) -> None:
    if corpus.dtype not in KERNEL_KINDS:
        raise TypeError(
            f"the {what} kernel reads int8, bfloat16 or float32 rows, got {corpus.dtype}"
        )


def check_kernel_rows(corpus, what: str, mode: str = "v2") -> int:
    """Row width in bytes that `csrc/section.cu` takes for ``corpus`` under
    epilogue ``mode``, or a raise: int8, bfloat16 or float32 rows of any
    width (the wgmma walk streams the query tile of rows past 2944 bytes, the
    FMA walk always streams its float32 queries) read in place, so their
    starts must lie a 16-byte multiple apart on a 16-byte aligned base, as
    TMA takes them (`is_pitched`)."""
    _check_kind(corpus, what)
    row_bytes = corpus.shape[1] * corpus.element_size()
    if not is_pitched(corpus):
        raise ValueError(
            f"the {what} kernel reads rows whose starts lie a 16-byte multiple apart "
            f"on a 16-byte aligned base, got {corpus.shape[1]} × {corpus.element_size()} "
            f"bytes at strides {tuple(corpus.stride())} (`pitched` copies them)"
        )
    return row_bytes


def kernel_operands(corpus, q, what: str):
    """(corpus, prepared queries, their int8 scales or None, row bytes) for
    a launch. The kernels load rows by TMA, whose row stride is a multiple of
    16 bytes: a corpus read in place (the store's rows, `pitched_zeros`) is
    passed as it is, any other is copied to a 16-byte pitch once
    (`corpus_copies`); queries are prepared and copied likewise."""
    global corpus_copies
    _check_kind(corpus, what)
    if not is_pitched(corpus):
        corpus = pitched(corpus)
        corpus_copies += 1
    qp, q_scale = prepare_queries(q, corpus)
    return corpus, pitched(qp), q_scale, check_kernel_rows(corpus, what)


def globalize_rows(pos: torch.Tensor, block_rows: int, n: int) -> torch.Tensor:
    """Table positions [B, W] → global rows: column c = block·128 + lane,
    row = block·block_rows + pos·128 + lane, clamped to n − 1 (an all-masked
    bucket decodes junk bits as its position)."""
    cols = torch.arange(pos.shape[1], dtype=torch.int32, device=pos.device)
    base = (cols // BUCKET) * block_rows + cols % BUCKET
    return torch.clamp(base[None, :] + pos * BUCKET, max=n - 1)


def matmul_bucket_max_v2_reference(corpus, q, mask, scale=None):
    """Plain version: (bucket max [B, W] f32 with the low bits cleared,
    global rows [B, W] int32), W = N/block_rows·128."""
    n = corpus.shape[0]
    block_rows = choose_block_rows(n)
    qp, q_scale = prepare_queries(q, corpus)
    c_scale = None if scale is None else scale.reshape(-1)
    b, p = qp.shape[0], block_rows // BUCKET
    pos = _positions(block_rows, corpus.device)
    step = max(PLAIN_CHUNK_ROWS // block_rows, 1) * block_rows
    bests = []
    for start in range(0, n, step):
        stop = min(n, start + step)
        s = block_scores(
            qp, q_scale, corpus[start:stop], None if c_scale is None else c_scale[start:stop]
        )
        packed = _pack_pos(s.reshape(b, -1, p, BUCKET), pos)
        live = mask[start:stop].reshape(1, -1, p, BUCKET)
        bests.append(torch.where(live, packed, NEG_INF).amax(dim=2).reshape(b, -1))
    vals, winner = _unpack(torch.cat(bests, dim=1))
    return vals, globalize_rows(winner, block_rows, n)


def matmul_bucket_max_v2_cuda(corpus, q, mask, scale=None):
    """Launch the CUDA kernel: same outputs as the plain version."""
    global launches
    n = corpus.shape[0]
    block_rows = choose_block_rows(n)
    if not (corpus.is_cuda and q.is_cuda and mask.is_cuda):
        raise ValueError("matmul_bucket_max_v2_cuda needs CUDA tensors")
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise ValueError(f"mask must be bool [{n}], got {mask.dtype} {tuple(mask.shape)}")
    corpus, qp, q_scale, row_bytes = kernel_operands(corpus, q, "bucket")
    c_scale = None
    if corpus.dtype == torch.int8:
        c_scale = _aligned(scale.reshape(-1).float().contiguous())
    mask = _aligned(mask.contiguous())
    queries, stages = table_geometry(corpus.dtype, row_bytes, "v2")
    lib = cuda_build.load("section")
    width = (n // block_rows) * BUCKET
    vals = torch.empty((qp.shape[0], width), dtype=torch.float32, device=corpus.device)
    pos = torch.empty((qp.shape[0], width), dtype=torch.int32, device=corpus.device)
    if vals.numel():
        fn = lib.bucket_max_v2
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_longlong] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        with torch.cuda.device(corpus.device):
            rc = fn(
                qp.data_ptr(), corpus.data_ptr(), _ptr(q_scale), _ptr(c_scale), mask.data_ptr(),
                vals.data_ptr(), pos.data_ptr(), row_bytes, row_pitch_bytes(qp),
                row_pitch_bytes(corpus), KERNEL_KINDS[corpus.dtype], qp.shape[0], n, block_rows,
                queries, stages,
                torch.cuda.current_stream(corpus.device).cuda_stream,
            )
        cuda_build.check(rc, "bucket_max_v2")
        launches += 1
    return vals, globalize_rows(pos, block_rows, n)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    walks bulk-copy the mask and scales)."""
    return t.clone() if t.data_ptr() % 16 else t


def matmul_bucket_max_v2(
    corpus, q, mask, variant: str = "onedot", chunk_pos: int = 16, scale=None
):
    """Strided-bucket fused scores + reduce: (bucket max [B, W] f32 with the
    low 7 mantissa bits zeroed, global rows [B, W] int32).

    ``variant`` ("onedot" or "chunked", with ``chunk_pos`` dividing the
    positions) is validated as in the JAX package; both name the same
    function, computed by one kernel. A CPU tensor takes the plain version,
    a CUDA tensor the kernel (or a raise).
    """
    n = corpus.shape[0]
    block_rows = choose_block_rows(n)
    if block_rows is None:
        raise ValueError(
            f"corpus rows ({n}) must be ≤ {BLOCK_ROWS} (and a multiple of "
            f"{BUCKET}) or divisible by a block size ≥ {MIN_BLOCK_ROWS}"
        )
    if corpus.dtype == torch.int8 and scale is None:
        raise ValueError("quantized corpus requires scale")
    if variant == "chunked":
        if (block_rows // BUCKET) % chunk_pos != 0:
            raise ValueError(
                f"chunk_pos ({chunk_pos}) must divide positions ({block_rows // BUCKET})"
            )
    elif variant != "onedot":
        raise ValueError(f"unknown variant {variant!r}")
    if corpus.device.type == "cpu":
        return matmul_bucket_max_v2_reference(corpus, q, mask, scale)
    return matmul_bucket_max_v2_cuda(corpus, q, mask, scale)


def fused_candidate_topk_v2(
    corpus, q, k: int, mask, variant: str = "onedot", chunk_pos: int = 16, scale=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate top-k over the bucket table: (scores [B, k] f32, rows
    [B, k] int32; −1 where masked or absent). ``k`` is cut to the table
    width; selection is exact, lowest column first among ties."""
    from .dense import topk

    vals, rows = matmul_bucket_max_v2(
        corpus, q, mask, variant=variant, chunk_pos=chunk_pos, scale=scale
    )
    k = min(k, vals.shape[1])
    top_vals, pos = topk(vals, k)
    top_rows = torch.gather(rows, 1, pos)
    return top_vals, torch.where(top_vals > NEG_INF / 2, top_rows, -1)


# -- v1: consecutive buckets, exact maximum, highest-lane argmax -----------------


def _check_v1_geometry(corpus) -> None:
    """The JAX function's geometry errors, word for word, and v1's dtypes."""
    n = corpus.shape[0]
    if n % BUCKET != 0:
        raise ValueError(f"corpus rows ({n}) must be a multiple of {BUCKET}")
    if n > BLOCK_ROWS and n % BLOCK_ROWS != 0:
        raise ValueError(
            f"corpus rows ({n}) must be ≤ {BLOCK_ROWS} or a multiple of it "
            "(store capacities are powers of two of the block size)"
        )
    if corpus.dtype == torch.int8:
        raise ValueError(
            "matmul_bucket_max takes bf16 or float32 rows: an int8 corpus has no "
            "scale in v1 (use matmul_bucket_max_v2 with scale=)"
        )


def matmul_bucket_max_reference(corpus, q, mask):
    """Plain version: (bucket max [B, N/128] f32, global rows [B, N/128]
    int32), scores computed per chunk of rows."""
    n = corpus.shape[0]
    qp = q.to(corpus.dtype)
    lane = torch.arange(BUCKET, dtype=torch.int32, device=corpus.device)
    vals, rows = [], []
    for start in range(0, n, PLAIN_CHUNK_ROWS):
        stop = min(n, start + PLAIN_CHUNK_ROWS)
        s = block_scores(qp, None, corpus[start:stop], None)
        s = torch.where(mask[start:stop][None, :], s, NEG_INF).reshape(qp.shape[0], -1, BUCKET)
        best = s.amax(dim=-1)
        winner = torch.where(s >= best[..., None], lane, -1).amax(dim=-1)
        base = torch.arange(start, stop, BUCKET, dtype=torch.int32, device=corpus.device)
        vals.append(best)
        rows.append(base[None, :] + winner)
    return torch.cat(vals, dim=1), torch.cat(rows, dim=1)


def v1_block_rows(n: int, batch: int, dtype, n_sm: int, row_bytes: int) -> int:
    """Rows per column block of the v1 kernel. Any 128-multiple that divides
    ``n`` gives the same table, so take the largest ≤ 16384 and halve it
    (down to 1024) while the grid holds fewer than two waves of one CTA an
    SM (a CTA of either walk takes a whole SM)."""
    block = min(n, BLOCK_ROWS)
    tiles = -(-batch // tile_queries(dtype, row_bytes, "v1"))
    while (n // block) * tiles < 2 * n_sm and block > 1024:
        half = block // 2
        if half % BUCKET or n % half:
            break
        block = half
    return block


def matmul_bucket_max_cuda(corpus, q, mask):
    """Launch `csrc/section.cu::bucket_max_v1`: the plain version's outputs."""
    global launches_v1
    _check_v1_geometry(corpus)
    if not (corpus.is_cuda and q.is_cuda and mask.is_cuda):
        raise ValueError("matmul_bucket_max_cuda needs CUDA tensors")
    n, d = corpus.shape
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"queries must be [B, {d}], got {tuple(q.shape)}")
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise ValueError(f"mask must be bool [{n}], got {mask.dtype} {tuple(mask.shape)}")
    corpus, qp, _, row_bytes = kernel_operands(corpus, q, "bucket v1")
    mask = _aligned(mask.contiguous())
    batch = qp.shape[0]
    vals = torch.empty((batch, n // BUCKET), dtype=torch.float32, device=corpus.device)
    rows = torch.empty((batch, n // BUCKET), dtype=torch.int32, device=corpus.device)
    if vals.numel():
        n_sm = torch.cuda.get_device_properties(corpus.device).multi_processor_count
        block = v1_block_rows(n, batch, corpus.dtype, n_sm, row_bytes)
        queries, stages = table_geometry(corpus.dtype, row_bytes, "v1")
        fn = cuda_build.load("section").bucket_max_v1
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_longlong] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        with torch.cuda.device(corpus.device):
            rc = fn(
                qp.data_ptr(), corpus.data_ptr(), mask.data_ptr(), vals.data_ptr(), rows.data_ptr(),
                row_bytes, row_pitch_bytes(qp), row_pitch_bytes(corpus), KERNEL_KINDS[corpus.dtype],
                batch, n, block, queries, stages,
                torch.cuda.current_stream(corpus.device).cuda_stream,
            )
        cuda_build.check(rc, "bucket_max_v1")
        launches_v1 += 1
    return vals, rows


def matmul_bucket_max(corpus, q, mask):
    """Consecutive-bucket fused scores + reduce: (bucket max [B, N/128] f32,
    global argmax rows [B, N/128] int32; all-masked buckets carry -1e30).

    A CPU tensor takes the plain version, a CUDA tensor the kernel (or a
    raise)."""
    _check_v1_geometry(corpus)
    if corpus.device.type == "cpu":
        return matmul_bucket_max_reference(corpus, q, mask)
    return matmul_bucket_max_cuda(corpus, q, mask)


def fused_candidate_topk(corpus, q, k: int, mask) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate top-k over the v1 bucket table: (scores [B, k] f32, rows
    [B, k] int32; −1 where masked or absent). ``k`` is cut to N/128;
    selection is exact, lowest bucket first among ties."""
    from .dense import topk

    vals, rows = matmul_bucket_max(corpus, q, mask)
    k = min(k, vals.shape[1])
    top_vals, pos = topk(vals, k)
    top_rows = torch.gather(rows, 1, pos)
    return top_vals, torch.where(top_vals > NEG_INF / 2, top_rows, -1)
