"""The flash-attention backward of the PyTorch port vs the JAX package.

On the same numpy inputs:

- the port's plain FA2 backward (`flash_attention_bwd_reference`) against
  the JAX Pallas backward (`flash_attention_bwd_tpu`, 64-row blocks, run in
  interpret mode) fed the lse of the JAX forward kernel
  (`flash_attention_tpu_lse`, interpret mode): global, windowed, a
  non-dividing S, a zero-length row, float32 and bf16;
- the same against `jax.vjp` of the JAX reference attention on live rows
  (the cotangent is 0 on padded query rows, as in a train step);
- the port's `attention_lse_reference` against the JAX kernel's lse;
- the port's differentiable `flash_attention` (autograd on the CPU) against
  both;
- `matmul_f32`'s gradients against JAX's VJP of the encoder's `_dense` on
  bf16 operands, bit-equal.

Tolerances: float32 rtol/atol 5e-4 (the ROADMAP's float32 limit; sums in
another order). bf16 inputs: atol 2e-2 + rtol 2e-2 — both sides compute in
float32 from the same bf16 values, but the outputs are rounded to bf16
(2⁻⁸ relative) and a value near a rounding boundary can land one bf16 ulp
apart. The CUDA kernels are held to these plain versions on the card in
`tests/test_torch_cuda_kernels.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.models.encoder import _dense
from verbatim_rag_tpu.ops.flash_attention import (
    attention_reference as jax_reference,
    flash_attention_bwd_tpu,
    flash_attention_tpu_lse,
)
from verbatim_rag_tpu_torch.ops import flash_attention as fa
from verbatim_rag_tpu_torch.ops.dense import matmul_f32

F32_TOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

CASES = {
    # name: (batch, seq, heads, head_dim, lengths, window)
    "global": (2, 128, 2, 32, [128, 77], None),
    "window": (2, 128, 2, 32, [128, 77], 32),
    "nondividing": (2, 200, 1, 64, [200, 131], None),
    "nondividing_window": (2, 200, 1, 64, [190, 200], 16),
    "zero_length": (3, 96, 2, 16, [96, 0, 40], 24),
}


def _inputs(batch, seq, heads, head_dim, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (
        rng.normal(size=(batch, seq, heads, head_dim)).astype(np.float32) for _ in range(4)
    )
    return q, k, v, g, np.asarray(lengths, np.int32)


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _jax_kernels(q, k, v, g, lens, window, dtype):
    """JAX forward kernel (out, lse) and backward kernel (dq, dk, dv), interpret mode."""
    jd = _jax_dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(x, jd) for x in (q, k, v, g))
    jl = jnp.asarray(lens)
    out, lse = flash_attention_tpu_lse(
        jq, jk, jv, jl, window=window, q_block=64, k_block=64, interpret=True
    )
    grads = flash_attention_bwd_tpu(
        jq, jk, jv, jl, out, lse, jg, window=window, q_block=64, k_block=64, interpret=True
    )
    return out, lse, grads


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_interpreted_tpu_kernel(case, dtype):
    batch, seq, heads, head_dim, lengths, window = CASES[case]
    q, k, v, g, lens = _inputs(batch, seq, heads, head_dim, lengths, seed=len(case))
    out, lse, expected = _jax_kernels(q, k, v, g, lens, window, dtype)
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, g)]
    got = fa.flash_attention_bwd_reference(
        t[0], t[1], t[2], torch.from_numpy(lens), torch.from_numpy(_as_np(out)).to(dtype),
        torch.from_numpy(_as_np(lse)), t[3], window,
    )
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for name, a, e in zip(("dq", "dk", "dv"), got, expected):
        assert a.dtype == dtype and a.shape == q.shape
        np.testing.assert_allclose(_as_np(a), _as_np(e), err_msg=name, **tol)
    if case == "zero_length":
        for a in got:  # the dead row neither attends nor is attended to
            assert (_as_np(a)[1] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_reference_matches_interpreted_tpu_kernel(case):
    batch, seq, heads, head_dim, lengths, window = CASES[case]
    q, k, v, _, lens = _inputs(batch, seq, heads, head_dim, lengths, seed=1)
    out, lse, _ = _jax_kernels(q, k, v, q, lens, window, torch.float32)
    got_out, got_lse = fa.attention_lse_reference(*map(torch.from_numpy, (q, k, v, lens)), window)
    assert got_lse.shape == (batch, heads, seq) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), **F32_TOL)
    live = np.arange(seq)[None, :] < lens[:, None]
    np.testing.assert_allclose(got_out.numpy()[live], np.asarray(out)[live], **F32_TOL)


def _jax_vjp(q, k, v, g, lens, window):
    """Gradients of the JAX reference attention, the cotangent zeroed on
    padded query rows."""
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jax_reference(a, b, c, jnp.asarray(lens), window), jq, jk, jv)
    return vjp(jnp.asarray(g))


def _live_cotangent(g, lens):
    live = np.arange(g.shape[1])[None, :] < lens[:, None]
    return (g * live[:, :, None, None]).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_reference_vjp(case):
    batch, seq, heads, head_dim, lengths, window = CASES[case]
    q, k, v, g, lens = _inputs(batch, seq, heads, head_dim, lengths, seed=2)
    g = _live_cotangent(g, lens)
    expected = _jax_vjp(q, k, v, g, lens, window)
    t = [torch.from_numpy(x) for x in (q, k, v, lens)]
    out, lse = fa.attention_lse_reference(*t, window)
    got = fa.flash_attention_bwd_reference(*t, out, lse, torch.from_numpy(g), window)
    for name, a, e in zip(("dq", "dk", "dv"), got, expected):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), err_msg=name, **F32_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_on_cpu_matches_jax(case):
    """The differentiable `flash_attention` on CPU float32 tensors: its
    grads against JAX's reference VJP and against the JAX kernel backward."""
    batch, seq, heads, head_dim, lengths, window = CASES[case]
    q, k, v, g, lens = _inputs(batch, seq, heads, head_dim, lengths, seed=3)
    g = _live_cotangent(g, lens)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    out = fa.flash_attention(*leaves, torch.from_numpy(lens), window)
    out.backward(torch.from_numpy(g))
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == before
    live = np.arange(seq)[None, :] < lens[:, None]
    np.testing.assert_allclose(
        out.detach().numpy()[live],
        np.asarray(jax_reference(*map(jnp.asarray, (q, k, v, lens)), window))[live],
        **F32_TOL,
    )
    _, _, kernel_grads = _jax_kernels(q, k, v, g, lens, window, torch.float32)
    for expected in (_jax_vjp(q, k, v, g, lens, window), kernel_grads):
        for name, x, e in zip(("dq", "dk", "dv"), leaves, expected):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(e), err_msg=name, **F32_TOL)


def test_no_grad_inputs_take_the_forward_alone():
    q, k, v, _, lens = map(torch.from_numpy, _inputs(2, 48, 2, 16, [48, 5], seed=4))
    out = fa.flash_attention(q, k, v, lens, 16)
    assert out.grad_fn is None
    torch.testing.assert_close(out, fa.attention_reference(q, k, v, lens, 16), rtol=0, atol=0)
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(), k, v, lens, 16)
    assert out.grad_fn is None


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, g, lens = map(torch.from_numpy, _inputs(1, 16, 1, 64, [16], seed=5))
    out, lse = fa.attention_lse_reference(q, k, v, lens)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_lse_cuda(q, k, v, lens)


def _exact_operands(seed):
    """bf16 operands (multiples of 1/8) and a float32 cotangent (multiples of
    1/1024 with 13 significant bits): every product and sum is exact in
    float32, so any order of summation gives the same bits, while rounding
    the cotangent to bf16 before the product would change them."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(-16, 17, size=(24, 16)) / 8.0).astype(np.float32)
    b = (rng.integers(-16, 17, size=(16, 12)) / 8.0).astype(np.float32)
    g = (rng.integers(-4096, 4097, size=(24, 12)) / 1024.0).astype(np.float32)
    return a, b, g


@pytest.mark.parametrize("seed", [0, 1])
def test_matmul_f32_grads_bit_equal_to_jax_dense(seed):
    a, b, g = _exact_operands(seed)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    y, vjp = jax.vjp(lambda x, w: _dense({"kernel": w}, x, jnp.bfloat16), ja, jb)
    jda, jdb = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_()
    ty = matmul_f32(ta, tb)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    assert ta.grad.dtype == torch.bfloat16 and jda.dtype == jnp.bfloat16
    np.testing.assert_array_equal(ta.grad.float().numpy(), np.asarray(jda, np.float32))
    np.testing.assert_array_equal(tb.grad.float().numpy(), np.asarray(jdb, np.float32))
    # The rounding point is what the test holds: the cotangent rounded to
    # bf16 before the product gives other gradients.
    early = torch.from_numpy(g).to(torch.bfloat16).float() @ tb.detach().float().T
    assert not torch.equal(early.to(torch.bfloat16), ta.grad)


def test_matmul_f32_grads_in_float32_match_jax_dense():
    rng = np.random.default_rng(7)
    a, b, g = (rng.normal(size=s).astype(np.float32) for s in ((20, 12), (12, 9), (20, 9)))
    _, vjp = jax.vjp(lambda x, w: _dense({"kernel": w}, x, jnp.float32), jnp.asarray(a), jnp.asarray(b))
    jda, jdb = vjp(jnp.asarray(g))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    matmul_f32(ta, tb).backward(torch.from_numpy(g))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jda), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-6)
