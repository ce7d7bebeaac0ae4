"""Fused matmul + strided bucket-max candidate selection (port of the v2
kernel of `verbatim_rag_tpu/ops/fused_topk.py`).

For a corpus of N rows cut into blocks of ``block_rows`` (`choose_block_rows`),
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

#: Kernel launches since the last reset (the main path's proof of use).
launches = 0


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


#: Shared memory a CTA of `csrc/section.cu` may use, and what it takes
#: besides its query tile (three 128-row stages of 144 bytes a row).
_SMEM_LIMIT = 232448
_SMEM_STAGES = 3 * 128 * 144


def check_kernel_rows(corpus, what: str) -> int:
    """Row width in bytes that `csrc/section.cu` takes for ``corpus``, or a
    raise: int8 or bfloat16 rows, 16-byte multiples (the kernel copies rows
    in 16-byte pieces), and a 64-query tile that fits shared memory."""
    if corpus.dtype not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(
            f"the {what} kernel reads int8 or bfloat16 rows, got {corpus.dtype} "
            "(float32 arms are not ported to a kernel yet; a later slice)"
        )
    row_bytes = corpus.shape[1] * corpus.element_size()
    padded = -(-row_bytes // 128) * 128
    if row_bytes % 16 or 64 * (padded + 16) + _SMEM_STAGES > _SMEM_LIMIT:
        raise ValueError(
            f"the {what} kernel takes rows of a 16-byte multiple up to 2688 bytes, "
            f"got {corpus.shape[1]} × {corpus.element_size()} bytes"
        )
    return row_bytes


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
    row_bytes = check_kernel_rows(corpus, "bucket")
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise ValueError(f"mask must be bool [{n}], got {mask.dtype} {tuple(mask.shape)}")
    qp, q_scale = prepare_queries(q, corpus)
    c_scale = None
    if corpus.dtype == torch.int8:
        c_scale = scale.reshape(-1).float().contiguous()
    corpus = corpus.contiguous()
    mask = mask.contiguous()
    lib = cuda_build.load("section")
    width = (n // block_rows) * BUCKET
    vals = torch.empty((qp.shape[0], width), dtype=torch.float32, device=corpus.device)
    pos = torch.empty((qp.shape[0], width), dtype=torch.int32, device=corpus.device)
    if vals.numel():
        fn = lib.bucket_max_v2
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        rc = fn(
            qp.data_ptr(), corpus.data_ptr(), _ptr(q_scale), _ptr(c_scale), mask.data_ptr(),
            vals.data_ptr(), pos.data_ptr(), row_bytes,
            int(corpus.dtype == torch.int8), qp.shape[0], n, block_rows,
            torch.cuda.current_stream(corpus.device).cuda_stream,
        )
        cuda_build.check(rc, "bucket_max_v2")
        launches += 1
    return vals, globalize_rows(pos, block_rows, n)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


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
