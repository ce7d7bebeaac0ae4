"""Flash attention for the encoder stack: CUDA kernel + plain PyTorch twin.

Port of `verbatim_rag_tpu/ops/flash_attention.py` (forward only). The kernel
(`csrc/flash_attention.cu`: tensor cores for bf16, FMA for float32) replaces
the TPU kernel `_flash_kernel`;
:func:`attention_reference` is the plain version of the same function, kept
beside it as the CPU path and the kernel's oracle.

:func:`flash_attention` dispatches on the tensor's device alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises. The
kernel takes any sequence length and masks the ragged edge itself.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NEG_INF = -1e30

#: The one head dim the kernel is compiled for (ModernBERT's).
KERNEL_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset (the main path's proof of use).
launches = 0


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


def flash_attention_cuda(q, k, v, lengths, window=None):
    """Launch the CUDA kernel: [B, S, H, D] in q's dtype → same shape/dtype."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda and lengths.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q, k, v must be equal [B, S, H, D], got {q.shape}, {k.shape}, {v.shape}")
    batch, seq, heads, head_dim = q.shape
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(f"kernel head_dim must be {KERNEL_HEAD_DIM}, got {head_dim}")
    if batch * heads > 65535:
        raise ValueError(f"batch*heads={batch * heads} exceeds the kernel grid (65535)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    if lengths.shape != (batch,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"lengths must be contiguous int32 [{batch}], got {lengths.dtype} {tuple(lengths.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cuda_build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        batch, seq, heads, head_dim, -1 if window is None else int(window),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(rc, "flash_attention_fwd")
    launches += 1
    return out


def flash_attention(q, k, v, lengths, window=None):
    """Attention over [B, S, H, D] with key padding and an optional local band.

    CPU tensors take :func:`attention_reference` (float32 out); CUDA tensors
    take the kernel (q's dtype out). There is no other path.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, lengths, window)
    return flash_attention_cuda(q, k, v, lengths, window)
