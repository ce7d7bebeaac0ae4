"""Dense brute-force retrieval: matmul + top-k (port of
`verbatim_rag_tpu/ops/dense.py`: bf16/f32 corpora and the int8 and int4
tiers).

Three rules carried over from the JAX package so scores and orders agree:

- a bf16 corpus is scored with bf16 operands and a float32 result
  (``preferred_element_type=float32`` in JAX); a plain bf16 matmul in torch
  would round the *output* to bf16 and reorder near-equal scores;
- an int8 corpus is scored as exact int32 dots of the int8 codes, then
  ``raw * (q_scale * c_scale.T)`` in float32 (the JAX order; the bucket and
  section kernels scale as ``(raw * q_scale) * c_scale`` instead, and each
  path keeps its own order);
- selection is exact with the lowest index first among equal values, like
  ``lax.top_k`` (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = -1e30


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis (float32 math)."""
    x = x.float()
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _row_max_over(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``max|x| / divisor`` per row, a true float32 division on every device.

    The divisor is a tensor on ``x``'s device: divided by a Python scalar,
    a CUDA tensor is multiplied by the scalar's reciprocal instead, which can
    differ in the last bit from the JAX store's numpy division."""
    return x.abs().amax(dim=-1, keepdim=True) / x.new_tensor(divisor)


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of stored rows: ``x ≈ q * scale``.

    Round half to even, codes clipped to ±127, scale ``max|x| / 127``
    clipped below at 1e-12; bit-equal to the JAX package's on equal float32
    inputs. Returns (int8 [N, d], float32 scales [N, 1]).
    """
    x = x.float()
    return _quantize_int8(x, _row_max_over(x, 127.0))


#: 1/127 in float32. The JAX package quantizes queries inside compiled
#: programs, where XLA turns ``max|x| / 127`` into ``max|x| * (1/127)``
#: (a reciprocal multiply, which can differ from the division in the last
#: bit); the port scales queries the same way so both pick the same codes.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_queries_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of queries, as the JAX package's compiled
    programs compute it: scale ``max|x| * (1/127)``, otherwise as
    :func:`quantize_rows_int8`."""
    x = x.float()
    return _quantize_int8(x, x.abs().amax(dim=-1, keepdim=True) * _INV_127)


class Int4Rows(NamedTuple):
    """Row matrix quantized to 4 bits, two codes per int8 byte.

    Byte ``j`` of a row holds column ``j`` in its low nibble and column
    ``j + d/2`` in its high nibble (the JAX package's half-split layout:
    unpacking is two shifts and a concatenation). Codes are symmetric in
    [-7, 7] with a per-row float32 scale. The packed bytes are ``int8``, so
    they travel in this carrier from the store to `dense_scores`: a bare
    packed tensor would pass for int8 codes wherever a path routes on
    ``dtype == torch.int8``.
    """

    packed: torch.Tensor  # [N, d//2] int8
    scale: torch.Tensor  # [N, 1] f32

    @property
    def shape(self) -> tuple[int, int]:
        return (self.packed.shape[0], self.packed.shape[1] * 2)


def quantize_rows_int4(x) -> Int4Rows:
    """Symmetric per-row int4 quantization, packed two codes per byte:
    ``x ≈ unpack_int4(packed) * scale``, scale ``max|x| / 7`` clipped below at
    1e-12, codes rounded half to even and clipped to ±7. Takes numpy or torch
    input and returns the same kind; bit-equal to the JAX package's on equal
    float32 inputs. The column count must be even."""
    if isinstance(x, np.ndarray):
        rows = quantize_rows_int4(torch.from_numpy(np.ascontiguousarray(x)))
        return Int4Rows(rows.packed.numpy(), rows.scale.numpy())
    x = x.float()
    if x.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even column count, got {tuple(x.shape)}")
    half = x.shape[-1] // 2
    scale = torch.clamp(_row_max_over(x, 7.0), min=1e-12)
    codes = torch.clamp(torch.round(x / scale), -7, 7).to(torch.int8)
    lo = codes[..., :half] & 0xF
    hi = codes[..., half:] & 0xF
    return Int4Rows(lo | (hi << 4), scale)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, d//2] packed bytes → [N, d] int8 codes in [-7, 7].

    Arithmetic shifts sign-extend the nibbles ((b << 4) >> 4 for the low
    one); the half-split layout restores column order with a concatenation.
    """
    return torch.cat([(packed << 4) >> 4, packed >> 4], dim=-1)


class _MatmulF32(torch.autograd.Function):
    """bf16 × bf16 → float32 on the tensor cores, differentiable.

    ``torch.mm(..., out_dtype=float32)`` has no derivative, so the backward
    is written out, as JAX transposes ``dot_general(...,
    preferred_element_type=float32)``: the float32 cotangent meets the other
    operand in a float32 product, and only then is the gradient rounded to
    the operand's dtype (rounding the cotangent to bf16 first would give
    other values).
    """

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        da = torch.mm(g, b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = torch.mm(a.float().t(), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result, whatever the operands' float dtype.

    On CUDA a bf16 product runs on the tensor cores with float32 output
    (:class:`_MatmulF32`); elsewhere, and for float32, the operands are
    multiplied in float32 (products of bf16 values are exact in float32).
    Both are differentiable with the same gradients. TF32 is never used:
    float32 products stay float32.
    """
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return _MatmulF32.apply(a, b)
    return torch.mm(a.float(), b.float())


#: Widest int8 dot whose float32 product of the codes is exact
#: (127² · 1040 < 2²⁴: every partial sum is an integer float32 holds).
_EXACT_F32_DEPTH = 1040


def int8_dots(qi: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int32 dots of int8 rows, [B, d] × [N, d] → [B, N] as float32.

    On CUDA a plain ``torch._int_mm`` (int8 tensor cores, int32 sums) where
    its shape rules hold; elsewhere a float32 product of the codes, exact for
    d ≤ 1040 (float64 above that). For d ≤ 1040 the values are integers
    below 2²⁴ in magnitude, so the float32 result is exact.
    """
    b, d = qi.shape
    n = codes.shape[0]
    if qi.is_cuda and b > 16 and d % 8 == 0 and n % 8 == 0:
        return torch._int_mm(qi.contiguous(), codes.t()).float()
    wide = torch.float32 if d <= _EXACT_F32_DEPTH else torch.float64
    return torch.mm(qi.to(wide), codes.to(wide).t()).float()


def dense_scores(corpus, queries, corpus_scale=None) -> torch.Tensor:
    """[B, N] cosine scores of row-normalized queries.

    For an int8 corpus (or an :class:`Int4Rows` one, whose codes are
    unpacked first) the queries are quantized per row on the fly and the
    int32 dots are rescaled: ``raw * (q_scale * corpus_scale.T)``.
    """
    if isinstance(corpus, Int4Rows):
        qi, q_scale = quantize_queries_int8(queries)
        raw = int8_dots(qi, unpack_int4(corpus.packed))
        return raw * (q_scale * corpus.scale.reshape(1, -1))
    if corpus.dtype == torch.int8:
        if corpus_scale is None:
            raise ValueError("int8 corpus requires corpus_scale")
        qi, q_scale = quantize_queries_int8(queries)
        raw = int8_dots(qi, corpus)
        return raw * (q_scale * corpus_scale.reshape(1, -1))
    return matmul_f32(queries.to(corpus.dtype), corpus.t())


def _orderable(x: torch.Tensor) -> torch.Tensor:
    """float32 → int64 whose signed order is the float order (no NaNs)."""
    bits = x.float().contiguous().view(torch.int32).long()
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _topk_by_key(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each value packed with its reversed column index into one int64 key:
    every key is distinct, so ``torch.topk`` on the keys orders by (value
    desc, index asc)."""
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device, dtype=torch.int64)
    keys = (_orderable(scores) << 32) | (n - 1 - idx)
    _, pos = torch.topk(keys, k, dim=-1, sorted=True)
    return torch.gather(scores, -1, pos), pos


def topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis of [B, N] with ``lax.top_k``'s tie
    order: equal values come lowest index first.

    ``torch.topk`` on the float scores picks a correct set of values, but
    among values equal to the k-th it may keep any columns, and it orders
    equal values arbitrarily. The selected k are therefore re-sorted by
    (value desc, index asc), and only the rows where more columns tie with
    the k-th value than were kept are selected again with distinct int64
    keys (rows with masked −1e30 tails, duplicate documents).
    """
    vals, pos = torch.topk(scores, k, dim=-1, sorted=True)
    order = torch.argsort(pos, dim=-1)
    vals, pos = vals.gather(-1, order), pos.gather(-1, order)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)
    vals, pos = vals.gather(-1, order), pos.gather(-1, order)
    kth = vals[:, -1:]
    redo = (scores == kth).sum(-1) > (vals == kth).sum(-1)
    rows = redo.nonzero().squeeze(-1)
    if rows.numel():
        vals[rows], pos[rows] = _topk_by_key(scores[rows], k)
    return vals, pos


def bucket_kernel_supported(corpus, scale, k: int | None = None) -> bool:
    """Whether the fused bucket-max kernel can serve this request: the
    kernel's block geometry, a bucket table wide enough to supply ``k``
    candidates, and, for an int8 corpus, its per-row scale.

    Unlike the JAX package there is no backend test: on a CPU tensor the
    bucket path runs its plain version, on a CUDA tensor the kernel. An
    :class:`Int4Rows` corpus never rides it (the JAX package removed its
    int4 arm): the int4 tier always takes the "xla" path.
    """
    from .fused_topk import bucket_table_width

    if isinstance(corpus, Int4Rows):
        return False
    if corpus.dtype == torch.int8 and scale is None:
        return False
    width = bucket_table_width(corpus.shape[0])
    return width is not None and (k is None or k <= width)


def candidate_topk(
    corpus, queries, k: int, mask=None, scale=None, exact_topk: bool = False,
    impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate selection for the fused programs: (scores [B, k], rows [B, k]).

    impl="xla": the [B, N] score matrix (masked rows at -1e30), then exact
    top-k. impl="bucket": the fused matmul + strided bucket-max
    (`ops/fused_topk.py`), whose [B, N] scores never exist; it falls back to
    the "xla" path where its geometry or table width cannot serve the
    request. The bucket table keeps one winner per bucket, so a request for
    exact selection (``exact_topk=True``) never takes it, nor does an
    :class:`Int4Rows` corpus. Selection on the "xla" path is exact either way.
    """
    if impl not in ("xla", "bucket"):
        raise ValueError(f"unknown candidate impl {impl!r}")
    if impl == "bucket" and not exact_topk and bucket_kernel_supported(corpus, scale, k):
        from .fused_topk import fused_candidate_topk_v2

        if mask is None:
            mask = torch.ones(corpus.shape[0], dtype=torch.bool, device=corpus.device)
        q = queries if corpus.dtype == torch.int8 else queries.to(corpus.dtype)
        return fused_candidate_topk_v2(corpus, q, k, mask, scale=scale)
    scores = dense_scores(corpus, queries, scale)
    if mask is not None:
        scores = torch.where(mask[None, :], scores, NEG_INF)
    return topk(scores, k)


def dense_topk(corpus, queries, k: int, mask=None, exact_topk: bool = True, corpus_scale=None):
    """Cosine top-k: (scores [B, k], row indices [B, k]); masked rows score
    -1e30. Selection is exact whatever ``exact_topk`` says (the port has no
    ``approx_max_k``)."""
    scores = dense_scores(corpus, queries, corpus_scale)
    if mask is not None:
        scores = torch.where(mask[None, :], scores, NEG_INF)
    return topk(scores, k)
