"""Flash attention for the encoder stack: CUDA kernels + plain PyTorch twins.

Port of `verbatim_rag_tpu/ops/flash_attention.py`. The kernels replace the
TPU kernels of that module:

- `csrc/flash_attention.cu` (tensor cores for bf16, FMA for float32) the
  forward `_flash_kernel`, with the logsumexp output of
  `flash_attention_tpu_lse` on request, and the ring step
  `_flash_partial_kernel` (:func:`flash_attention_partial`: one KV block's
  unnormalised numerator, row max and denominator);
- `csrc/flash_attention_bwd.cu` the FlashAttention-2 backward
  `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`.

Every kernel is compiled at head dims 32 (MiniLM's 12 × 32 heads: the
providers, the cross-encoder, a MiniLM-width highlighter trained or run
sequence-parallel) and 64 (ModernBERT's 12 × 64 heads: the extractor).
Each entry takes the head dims of its kernel (:data:`FORWARD_HEAD_DIMS`,
:data:`PARTIAL_HEAD_DIMS`, :data:`BACKWARD_HEAD_DIMS`); on CUDA any other
raises ``ValueError``, a differentiable call included (its backward would
need the kernel). The ring step's partial is differentiable on both devices
(:class:`FlashAttentionPartial`: the kernel forward, a plain backward, as in
the JAX package).

:func:`attention_reference`, :func:`attention_lse_reference`,
:func:`flash_attention_bwd_reference` and
:func:`flash_attention_partial_reference` are the plain versions of the same
functions, kept beside them as the CPU path and the kernels' oracle.

:func:`flash_attention` dispatches on the tensor's device alone: a CPU tensor
takes the plain versions, a CUDA tensor launches the kernels or raises. When
an input requires grad it runs through :class:`FlashAttention`, whose forward
also keeps the logsumexp and whose backward is the FA2 backward (kernels on
CUDA); otherwise it runs the forward alone. The kernels take any sequence
length and mask the ragged edge themselves, and any batch: a batch whose
batch × heads passes the grid's 65,535 rows on y runs in slices, one launch
a slice (`cuda_build.grid_chunks`), inside the one call autograd sees. Rows with no live key (a
zero-length row, or a padded query of a local layer whose band holds no live
key) get zero gradients, as in the JAX package's kernel backward.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NEG_INF = -1e30

#: Head dims each kernel is compiled for: MiniLM's 32 and ModernBERT's 64.
FORWARD_HEAD_DIMS = (32, 64)
PARTIAL_HEAD_DIMS = (32, 64)
BACKWARD_HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset (the main path's proof of use): the
#: forward (with or without lse), the backward's dq and its dk/dv kernel, and
#: the ring step's partial kernel; each ``*_d32`` counts those at head dim 32
#: among them.
launches = 0
launches_d32 = 0
bwd_dq_launches = 0
bwd_dq_launches_d32 = 0
bwd_dkv_launches = 0
bwd_dkv_launches_d32 = 0
partial_launches = 0
partial_launches_d32 = 0


def _scale(head_dim: int) -> float:
    return 1.0 / float(head_dim) ** 0.5


def _live_mask(lengths, seq: int, window, device) -> torch.Tensor:
    """[B, 1, S, S] bool: key below its row's length and, with a window, in
    the band |q − k| ≤ window // 2."""
    kidx = torch.arange(seq, device=device)
    live = (kidx[None, :] < lengths.to(device)[:, None])[:, None, None, :]
    if window is not None:
        live = live & ((kidx[:, None] - kidx[None, :]).abs() <= window // 2)[None, None]
    return live


def attention_reference(q, k, v, lengths, window=None):
    """Plain version: [B, S, H, D] in → [B, S, H, D] float32 out.

    Mirrors the JAX reference: float32 logits scaled after the dot, additive
    -1e30 masks, softmax in float32, probabilities cast to v's dtype before
    the P·V product (accumulated in float32). A row whose keys are all
    masked gets the uniform average here; the kernel writes 0 there.
    """
    seq = q.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(q.device)
    kidx = torch.arange(seq, device=q.device)
    pad = (kidx[None, :] < lengths.to(q.device)[:, None]).float()
    bias = (1.0 - pad)[:, None, None, :] * NEG_INF
    if window is not None:
        dist = (kidx[:, None] - kidx[None, :]).abs()
        local = torch.where(dist <= window // 2, 0.0, NEG_INF).float()
        bias = bias + local[None, None, :, :]
    probs = torch.softmax(logits + bias, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())


def attention_lse_reference(q, k, v, lengths, window=None):
    """Plain version of the forward with its logsumexp: (out as
    :func:`attention_reference`, lse [B, H, S] float32).

    lse = m + log(l) over the live keys of the scaled scores, 0 for a row
    with no live key (as `flash_attention_tpu_lse` writes it).
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(q.shape[-1])
    live = _live_mask(lengths, q.shape[1], window, q.device)
    lse = torch.logsumexp(logits.masked_fill(~live, float("-inf")), dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, 0.0)
    return attention_reference(q, k, v, lengths, window), lse


def flash_attention_bwd_reference(q, k, v, lengths, out, lse, g, window=None):
    """Plain version of the FA2 backward over the full [S, S], in float32:
    (dq, dk, dv) in q's, k's and v's dtypes.

    The same arithmetic as `flash_attention_bwd_tpu`: p = exp(s − lse) on
    live pairs (0 elsewhere), delta = rowsum(g ∘ out), ds = p ∘ (g·vᵀ −
    delta)·scale, dq = ds·k, dk = dsᵀ·q, dv = pᵀ·g.
    """
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    scale = _scale(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    live = _live_mask(lengths, q.shape[1], window, q.device)
    p = torch.exp((s - lse.float()[..., None]).masked_fill(~live, float("-inf")))
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)  # [B, H, S]
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_head_dim(head_dim: int, head_dims, what: str) -> None:
    if head_dim not in head_dims:
        raise ValueError(f"{what}: the kernel takes head_dim in {head_dims}, got {head_dim}")


def _check_inputs(q, k, v, lengths, what: str, head_dims, same_seq: bool = True) -> None:
    """Device, dtype, shape, head dim, alignment and lengths of a kernel's
    inputs; k and v may hold another sequence length than q when
    ``same_seq`` is false."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda and lengths.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    kv_shape = q.shape if same_seq else (q.shape[0], k.shape[1], *q.shape[2:])
    if q.dim() != 4 or k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"q, k, v must be [B, S, H, D] alike, got {q.shape}, {k.shape}, {v.shape}")
    batch, _, heads, head_dim = q.shape
    _check_head_dim(head_dim, head_dims, what)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    if lengths.shape != (batch,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"lengths must be contiguous int32 [{batch}], got {lengths.dtype} {tuple(lengths.shape)}")


def _check_rows(x, q, name: str) -> None:
    """A [B, H, S] float32 per-row statistic of q (lse, delta)."""
    batch, seq, heads, _ = q.shape
    if x.shape != (batch, heads, seq) or x.dtype != torch.float32 or not x.is_contiguous() or not x.is_cuda:
        raise ValueError(f"{name} must be contiguous float32 [{batch}, {heads}, {seq}] on CUDA")


def _forward(q, k, v, lengths, window, with_lse: bool):
    global launches, launches_d32
    _check_inputs(q, k, v, lengths, "flash_attention_cuda", FORWARD_HEAD_DIMS)
    batch, seq, heads, head_dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    # The kernel's grid holds batch × heads on y: one launch per slice of
    # the batch that fits it.
    for b0, b1 in cuda_build.grid_chunks(batch, heads):
        with torch.cuda.device(q.device):
            rc = fn(
                q[b0:b1].data_ptr(), k[b0:b1].data_ptr(), v[b0:b1].data_ptr(),
                lengths[b0:b1].data_ptr(), out[b0:b1].data_ptr(),
                None if lse is None else lse[b0:b1].data_ptr(),
                b1 - b0, seq, heads, head_dim, -1 if window is None else int(window),
                _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
            )
        cuda_build.check(rc, "flash_attention_fwd")
        launches += 1
        launches_d32 += head_dim == 32
    return out, lse


def flash_attention_cuda(q, k, v, lengths, window=None):
    """Launch the forward kernel: [B, S, H, D] in q's dtype → same shape/dtype."""
    return _forward(q, k, v, lengths, window, with_lse=False)[0]


def flash_attention_lse_cuda(q, k, v, lengths, window=None):
    """Launch the forward kernel with its logsumexp output: (out [B, S, H, D]
    in q's dtype, lse [B, H, S] float32)."""
    return _forward(q, k, v, lengths, window, with_lse=True)


def _launch_bwd(q, k, v, lengths, lse, delta, g, window, kernels=("dq", "dkv")):
    """Launch the backward kernels with a given delta; (dq, dk, dv), each
    None when its kernel was not asked for. Each kernel's grid holds batch ×
    heads on y: one launch per slice of the batch that fits it."""
    global bwd_dq_launches, bwd_dq_launches_d32, bwd_dkv_launches, bwd_dkv_launches_d32
    batch, seq, heads, head_dim = q.shape
    lib = cuda_build.load("flash_attention_bwd")
    win = -1 if window is None else int(window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dq = torch.empty_like(q) if "dq" in kernels else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if "dkv" in kernels else (None, None)
    fn_dq, fn_dkv = lib.flash_bwd_dq, lib.flash_bwd_dkv
    fn_dq.restype = fn_dkv.restype = ctypes.c_int
    fn_dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn_dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for b0, b1 in cuda_build.grid_chunks(batch, heads):
        common = tuple(
            t[b0:b1].data_ptr() for t in (q, k, v, g, lse, delta, lengths)
        )
        shape = (b1 - b0, seq, heads, head_dim, win, _DTYPE_CODES[q.dtype], stream)
        if dq is not None:
            with torch.cuda.device(q.device):
                cuda_build.check(fn_dq(*common, dq[b0:b1].data_ptr(), *shape), "flash_bwd_dq")
            bwd_dq_launches += 1
            bwd_dq_launches_d32 += head_dim == 32
        if dk is not None:
            with torch.cuda.device(q.device):
                rc = fn_dkv(*common, dk[b0:b1].data_ptr(), dv[b0:b1].data_ptr(), *shape)
                cuda_build.check(rc, "flash_bwd_dkv")
            bwd_dkv_launches += 1
            bwd_dkv_launches_d32 += head_dim == 32
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, lengths, out, lse, g, window=None):
    """Launch the FA2 backward kernels: (dq, dk, dv) in q's dtype.

    ``out`` and ``lse`` are the forward's outputs, ``g`` the output's
    cotangent (cast to q's dtype: the kernels read dO in the inputs' type).
    delta = rowsum(g ∘ out) is a torch reduction here, outside the kernels,
    as the JAX package computes it outside its Pallas calls.
    """
    _check_inputs(q, k, v, lengths, "flash_attention_bwd_cuda", BACKWARD_HEAD_DIMS)
    g = g.to(q.dtype).contiguous()
    if g.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"out and g must be {tuple(q.shape)}, got {tuple(out.shape)}, {tuple(g.shape)}")
    _check_rows(lse, q, "lse")
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return _launch_bwd(q, k, v, lengths, lse, delta, g, window)


def flash_attention_partial_reference(q, k, v, lengths, k_offset: int):
    """Plain version of one ring step: q [B, Sq, H, D] against ONE KV block
    k, v [B, Sk, H, D] whose first key sits at global position ``k_offset``.

    Returns (numer [B, Sq, H, D], m [B, H, Sq], l [B, H, Sq]), all float32:
    the unnormalised Σ p·v, the row max of the scaled scores and Σ p, with p
    = exp(s − m) on live keys (``k_offset + idx < lengths[b]``) and 0
    elsewhere. A row with no live key gets m = -1e30, l = 0, numer = 0. The
    arithmetic of the JAX package's `_partial_reference`: float32 scores
    scaled after the dot, P kept in float32.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(q.shape[-1])
    kidx = k_offset + torch.arange(k.shape[1], device=q.device)
    valid = (kidx[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    numer = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return numer, m, p.sum(dim=-1)


def flash_attention_partial_cuda(q, k, v, lengths, k_offset: int):
    """Launch the partial kernel: (numer [B, Sq, H, D], m [B, H, Sq],
    l [B, H, Sq]) float32, as :func:`flash_attention_partial_reference`."""
    global partial_launches, partial_launches_d32
    _check_inputs(q, k, v, lengths, "flash_attention_partial_cuda", PARTIAL_HEAD_DIMS, same_seq=False)
    k_offset = int(k_offset)
    if not 0 <= k_offset < 2**31:
        raise ValueError(f"k_offset must be a non-negative int32 position, got {k_offset}")
    batch, seq_q, heads, head_dim = q.shape
    numer = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if numer.numel() == 0:
        return numer, m, l
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_partial
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    # batch × heads on the grid's y, as the forward's: one launch a slice.
    for b0, b1 in cuda_build.grid_chunks(batch, heads):
        with torch.cuda.device(q.device):
            rc = fn(
                *(t[b0:b1].data_ptr() for t in (q, k, v, lengths, numer, m, l)),
                b1 - b0, seq_q, k.shape[1], heads, head_dim, k_offset,
                _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
            )
        cuda_build.check(rc, "flash_attention_partial")
        partial_launches += 1
        partial_launches_d32 += head_dim == 32
    return numer, m, l


class FlashAttentionPartial(torch.autograd.Function):
    """Differentiable ring step (JAX's ``custom_vjp`` on the partial kernel):
    the forward runs the kernel on CUDA and the plain version on the CPU and
    keeps (q, k, v, lengths, k_offset); the backward recomputes
    :func:`flash_attention_partial_reference` from them and takes its
    vector-Jacobian product for the cotangents of all three outputs, as
    JAX's ``_flash_partial_bwd`` does (its ``amax`` splits the max's
    gradient evenly over ties, as ``jnp.max``'s does). JAX has no kernel
    for this backward either."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, k_offset):
        if q.device.type == "cpu":
            out = flash_attention_partial_reference(q, k, v, lengths, k_offset)
        else:
            out = flash_attention_partial_cuda(q, k, v, lengths, k_offset)
        ctx.k_offset = k_offset
        ctx.save_for_backward(q, k, v, lengths)
        return out

    @staticmethod
    def backward(ctx, g_numer, g_m, g_l):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(need) for x, need in zip((q, k, v), ctx.needs_input_grad)]
            outs = flash_attention_partial_reference(*inputs, lengths, ctx.k_offset)
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, (g_numer, g_m, g_l)))
        return (*(next(grads).to(x.dtype) if x.requires_grad else None for x in inputs), None, None)


def flash_attention_partial(q, k, v, lengths, k_offset: int):
    """One KV block's unnormalised attention state, for the ring's online
    softmax merge (`ops.ring_attention.ring_attention`).

    CPU tensors take the plain version, CUDA tensors the kernel; there is no
    other path. ``k_offset`` is a host int. When grad is enabled and q, k or
    v requires it, the call is differentiable (:class:`FlashAttentionPartial`).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionPartial.apply(q, k, v, lengths, k_offset)
    if q.device.type == "cpu":
        return flash_attention_partial_reference(q, k, v, lengths, k_offset)
    return flash_attention_partial_cuda(q, k, v, lengths, k_offset)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward keeps (q, k, v, lengths,
    out, lse), the backward is the FA2 backward. CUDA tensors run the
    kernels, CPU tensors the plain versions. On CUDA a head dim the backward
    kernel does not take raises before the forward runs."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, window):
        if q.device.type == "cpu":
            out, lse = attention_lse_reference(q, k, v, lengths, window)
        else:
            _check_head_dim(q.shape[-1], BACKWARD_HEAD_DIMS, "flash_attention_bwd_cuda")
            out, lse = flash_attention_lse_cuda(q, k, v, lengths, window)
        ctx.window = window
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_bwd_reference(q, k, v, lengths, out, lse, g, ctx.window)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, lengths, out, lse, g, ctx.window)
        return (*grads, None, None)


def flash_attention(q, k, v, lengths, window=None):
    """Attention over [B, S, H, D] with key padding and an optional local band.

    CPU tensors take the plain versions (float32 out); CUDA tensors take the
    kernels (q's dtype out). There is no other path. When grad is enabled
    and q, k or v requires it, the call is differentiable (:class:`FlashAttention`).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, lengths, window)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, lengths, window)
    return flash_attention_cuda(q, k, v, lengths, window)
