"""The port's CUDA kernels and CUDA main path, on the card.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel has
no CPU mode). The file imports nothing of JAX, so it runs where the port
runs:

    python3 -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: section tables and bucket-max v2 on int8 rows bit-equal to their
plain versions (exact int32 sums, the same float operations); on bf16 and
float32 rows values within 2⁻¹⁵ of the dot's scale |q|·|c| (float32 sums in
another order, and the pack's 128-ulp step is 2⁻¹⁶ of a value) and rows equal
except in buckets whose two best scores lie within that. Bucket-max v1 (no
pack): bf16 within 2⁻¹⁵·|q|, float32 within 2⁻¹⁸·|q|, rows equal except in
buckets whose two best plain scores lie within that; on small-integer rows
(every dot exact) values and rows bit-equal, ties to the highest lane. Flash attention float32 1e-5. bf16 holds each live attention
row (b, q, h) to its own scale: max|out − plain| over D within 2e-2 of
max|plain| plus half a bf16 ulp of that max (the plain version rounds the
probabilities to bf16 before P·V, the kernel rounds the unnormalised ones,
and the output is bf16). Rescore rtol 1e-5 (float32 sums over the m slots
in another order; int16 ids and float16 weights widened alike), missing
candidates exactly −1e30. The flash backward and
the train step: see their tests' docstrings. The flash partial (one ring
step): m within 1e-5·|m| + 1e-6, l rtol 1e-4 (both sum the unrounded P),
the numerator float32 rtol/atol 1e-5 and bf16 per live row as the forward
(the kernel rounds P to bf16 for P·V, the plain version keeps it float32);
dead rows exactly (-1e30, 0, 0).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from verbatim_rag_tpu_torch.ops import flash_attention as fa
from verbatim_rag_tpu_torch.ops import fused_topk as ft
from verbatim_rag_tpu_torch.ops import rescore as rs
from verbatim_rag_tpu_torch.ops import section as sec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(batch, seq, heads, head_dim, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, seq, heads, head_dim)).astype(np.float32) for _ in range(3)]


def _bf16_row_ratio(got, expected, live, floor=0.0):
    """Worst live row (b, q, h): max|got − expected| over D divided by
    2e-2·max(max|expected|, floor·M) plus half a bf16 ulp of max|expected|,
    with M the largest |expected| over the live rows."""
    err = (got.float() - expected).abs().amax(dim=-1)
    scale = expected.abs().amax(dim=-1)
    _, exponent = torch.frexp(scale)
    base = torch.clamp(scale, min=floor * float(scale[live].max()))
    limit = 2e-2 * base + torch.ldexp(torch.ones_like(scale), exponent - 9)
    return float((err / limit)[live].max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 128, 7])
def test_flash_kernel_matches_plain(cuda, dtype, window):
    lengths = np.array([333, 0, 200, 17], np.int32)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(4, 333, 3, 64, 2))
    lens = torch.from_numpy(lengths).to(cuda)
    before = fa.launches
    got = fa.flash_attention(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    expected = fa.attention_reference(q, k, v, lens, window)
    live = torch.arange(333, device=cuda)[None, :] < lens[:, None]
    if dtype == torch.float32:
        torch.testing.assert_close(got[live], expected[live], rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_row_ratio(got, expected, live) <= 1.0
    assert (got[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 128, 7])
def test_flash_lse_kernel_matches_plain(cuda, dtype, window):
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(4, 333, 3, 64, 4))
    lens = torch.tensor([333, 0, 200, 17], dtype=torch.int32, device=cuda)
    before = fa.launches
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and lse.shape == (4, 3, 333)
    torch.testing.assert_close(out, fa.flash_attention_cuda(q, k, v, lens, window), rtol=0, atol=0)
    _, expected = fa.attention_lse_reference(q, k, v, lens, window)
    torch.testing.assert_close(lse, expected, rtol=1e-5, atol=1e-4)
    assert (lse[1] == 0).all()


def _bwd_inputs(cuda, dtype, seq, lengths, seed, heads=3, head_dim=64):
    q, k, v, g = (
        torch.from_numpy(np.random.default_rng(seed + i).normal(size=(len(lengths), seq, heads, head_dim)))
        .to(cuda, dtype) for i in range(4)
    )
    return q, k, v, g, torch.tensor(lengths, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 128, 7])
@pytest.mark.parametrize("seq,lengths", [(333, [333, 0, 200, 17]), (64, [64, 1]), (130, [129, 65])])
def test_flash_bwd_kernels_match_plain(cuda, dtype, window, seq, lengths):
    """dq, dk, dv against the plain FA2 backward on the kernel forward's out
    and lse: float32 rtol/atol 1e-4 (float32 sums in another order over up
    to S terms); bf16 each live row held as the forward's bf16 rows are
    (the kernels round P and dS to bf16 for the second products), with the
    row's scale floored at 1e-3 of the tensor's largest row: where one key
    takes all of a row's weight, dP − delta cancels, the true gradient is 0
    and both sides hold float32 noise (≈1e-7)."""
    q, k, v, g, lens = _bwd_inputs(cuda, dtype, seq, lengths, seed=seq)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (before[0] + 1, before[1] + 1)
    expected = fa.flash_attention_bwd_reference(q, k, v, lens, out, lse, g, window)
    live = torch.arange(seq, device=cuda)[None, :] < lens[:, None]
    for name, a, e in zip(("dq", "dk", "dv"), got, expected):
        assert a.dtype == dtype and a.shape == q.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4, msg=name)
        else:
            assert _bf16_row_ratio(a, e.float(), live, floor=1e-3) <= 1.0, name
        dead = ~live if name != "dq" else lens[:, None].expand_as(live) == 0
        assert (a[dead] == 0).all(), name


@pytest.mark.parametrize("window", [None, 128, 7])
@pytest.mark.parametrize("seq", [777, 4099])
def test_flash_bf16_kernels_off_the_tile_grid(cuda, seq, window):
    """The bf16 forward (with lse) and backward at S off the kernels' 64- and
    128-row tiles (TMA zero-fills the rows past S; the kernels mask them),
    ModernBERT's 12 heads, a zero-length row; rows held as in the tests
    above, lse as the lse test's."""
    q, k, v, g, lens = _bwd_inputs(cuda, torch.bfloat16, seq, [seq, 0, seq // 2 + 3], seq, heads=12)
    live = torch.arange(seq, device=cuda)[None, :] < lens[:, None]
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
    grads = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)
    torch.cuda.synchronize()
    expected_out, expected_lse = fa.attention_lse_reference(q, k, v, lens, window)
    assert _bf16_row_ratio(out, expected_out, live) <= 1.0
    torch.testing.assert_close(lse, expected_lse, rtol=1e-5, atol=1e-4)
    assert (out[1] == 0).all() and (lse[1] == 0).all()
    del expected_out, expected_lse
    expected = fa.flash_attention_bwd_reference(q, k, v, lens, out, lse, g, window)
    for name, a, e in zip(("dq", "dk", "dv"), grads, expected):
        assert _bf16_row_ratio(a, e.float(), live, floor=1e-3) <= 1.0, name
        assert (a[1] == 0).all(), name


@pytest.mark.parametrize("window", [None, 128])
def test_flash_bwd_kernels_are_deterministic(cuda, window):
    """No atomics: two backward calls give bit-equal dq, dk and dv."""
    q, k, v, g, lens = _bwd_inputs(cuda, torch.bfloat16, 1000, [1000, 0, 517], 5, heads=12)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
    first = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)
    second = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ["misaligned", "non_contiguous"])
def test_flash_kernels_refuse_misaligned_or_strided_inputs(cuda, fault):
    """The TMA tensor maps need contiguous rows on 16-byte boundaries: the
    wrappers raise before any launch."""
    q, k, v, g, lens = _bwd_inputs(cuda, torch.bfloat16, 130, [129, 65], 1)
    if fault == "misaligned":
        bad = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)[1:].view(k.shape)
        bad.copy_(k)
    else:
        bad = k.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(bad, k)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens)
    before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    for call in (
        lambda: fa.flash_attention_cuda(q, bad, v, lens),
        lambda: fa.flash_attention_lse_cuda(bad, k, v, lens),
        lambda: fa.flash_attention_bwd_cuda(q, bad, v, lens, out, lse, g),
        lambda: fa.flash_attention_bwd_cuda(q, k, bad, lens, out, lse, g),
    ):
        with pytest.raises(ValueError, match="contiguous and 16-byte aligned"):
            call()
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == before


def test_flash_autograd_on_cuda_matches_cpu(cuda):
    """The differentiable path runs one forward (lse), one dq and one dk/dv
    launch on CUDA, and its float32 grads match the CPU autograd's."""
    q, k, v, g, lens = _bwd_inputs(cuda, torch.float32, 200, [200, 77, 0], seed=9)
    g = g * (torch.arange(200, device=cuda)[None, :] < lens[:, None])[..., None, None]
    grads = []
    for device in ("cpu", "cuda"):
        leaves = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        out = fa.flash_attention(*leaves, lens.to(device), 16)
        out.backward(g.to(device))
        launched = (fa.launches - counts[0], fa.bwd_dq_launches - counts[1], fa.bwd_dkv_launches - counts[2])
        assert launched == ((1, 1, 1) if device == "cuda" else (0, 0, 0))
        grads.append([x.grad.cpu() for x in leaves])
    for a, e in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)


def test_matmul_f32_cuda_grads_match_plain(cuda):
    """The CUDA bf16 branch of `matmul_f32` against its CPU branch, bit-equal:
    operands are small multiples of 1/8 and the cotangent multiples of
    1/1024, so every product and sum is exact in float32 and only the final
    rounding to bf16 (where the gradient is rounded) can differ."""
    from verbatim_rag_tpu_torch.ops.dense import matmul_f32

    rng = np.random.default_rng(3)
    a_np = rng.integers(-16, 17, size=(48, 32)) / 8.0
    b_np = rng.integers(-16, 17, size=(32, 24)) / 8.0
    g_np = rng.integers(-4096, 4097, size=(48, 24)) / 1024.0
    results = []
    for device in ("cpu", "cuda"):
        a = torch.tensor(a_np, dtype=torch.bfloat16, device=device, requires_grad=True)
        b = torch.tensor(b_np, dtype=torch.bfloat16, device=device, requires_grad=True)
        y = matmul_f32(a, b)
        y.backward(torch.tensor(g_np, dtype=torch.float32, device=device))
        assert y.dtype == torch.float32 and a.grad.dtype == torch.bfloat16
        results.append([t.detach().cpu() for t in (y, a.grad, b.grad)])
    for got, expected in zip(results[1], results[0]):
        assert torch.equal(got, expected)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq,window", [(256, None), (200, None), (333, 128), (77, 7)])
def test_flash_kernel_head_dim_32_matches_plain(cuda, dtype, seq, window):
    """The forward's D = 32 arm (MiniLM's heads: 64-byte rows, the 64-byte
    swizzle, m64n32 P·V), ragged lengths with a zero-length row and a row of
    one key, at the same tolerances as D = 64; its launches count at D = 32."""
    lengths = np.array([seq, 0, 1, seq // 2 + 3, seq - 1, 17], np.int32)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(6, seq, 12, 32, seq))
    lens = torch.from_numpy(lengths).to(cuda)
    before = (fa.launches, fa.launches_d32)
    got = fa.flash_attention(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_d32) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    expected = fa.attention_reference(q, k, v, lens, window)
    live = torch.arange(seq, device=cuda)[None, :] < lens[:, None]
    if dtype == torch.float32:
        torch.testing.assert_close(got[live], expected[live], rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_row_ratio(got, expected, live) <= 1.0
    assert (got[1] == 0).all()
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    torch.testing.assert_close(lse, fa.attention_lse_reference(q, k, v, lens, window)[1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 128, 7])
@pytest.mark.parametrize(
    "seq,lengths", [(333, [333, 0, 200, 17]), (130, [129, 65]), (512, [512, 300, 1, 0, 511, 64])]
)
def test_flash_bwd_kernels_head_dim_32_match_plain(cuda, dtype, window, seq, lengths):
    """The backward's D = 32 arm (64-byte rows and swizzle, m64n32 products
    for dq, dk and dv) against the plain FA2 backward on the kernel
    forward's out and lse, MiniLM's 12 heads, ragged lengths with a
    zero-length row: the tolerances of the D = 64 test above; its launches
    count at D = 32 and rows with no live key get zero gradients."""
    q, k, v, g, lens = _bwd_inputs(cuda, dtype, seq, lengths, seed=seq + 32, heads=12, head_dim=32)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, lens, window)
    before = (fa.bwd_dq_launches_d32, fa.bwd_dkv_launches_d32)
    got = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches_d32, fa.bwd_dkv_launches_d32) == (before[0] + 1, before[1] + 1)
    expected = fa.flash_attention_bwd_reference(q, k, v, lens, out, lse, g, window)
    live = torch.arange(seq, device=cuda)[None, :] < lens[:, None]
    for name, a, e in zip(("dq", "dk", "dv"), got, expected):
        assert a.dtype == dtype and a.shape == q.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4, msg=name)
        else:
            assert _bf16_row_ratio(a, e.float(), live, floor=1e-3) <= 1.0, name
        dead = ~live if name != "dq" else lens[:, None].expand_as(live) == 0
        assert (a[dead] == 0).all(), name
    again = fa.flash_attention_bwd_cuda(q, k, v, lens, out, lse, g, window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "seq_q,seq_k,k_offset",
    [(128, 128, 0), (128, 128, 128), (128, 128, 256), (128, 128, 384), (200, 333, 150), (64, 0, 0)],
)
def test_flash_partial_kernel_head_dim_32_matches_plain(cuda, dtype, seq_q, seq_k, k_offset):
    """The partial's D = 32 arm at each offset of a 4-shard ring over 512
    tokens (the SP block of a MiniLM-width highlighter) and off the tiles:
    rows 0 and 1 live up to their lengths, row 2 empty; dead rows exactly
    (-1e30, 0, 0); the tolerances of the D = 64 test; its launches count at
    D = 32."""
    rng = np.random.default_rng(seq_q + seq_k + k_offset)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(3, s, 12, 32)).astype(np.float32)).to(cuda, dtype)
        for s in (seq_q, seq_k, seq_k)
    )
    lens = torch.tensor([512, 300, 0], dtype=torch.int32, device=cuda)
    before = (fa.partial_launches, fa.partial_launches_d32)
    numer, m, l = fa.flash_attention_partial(q, k, v, lens, k_offset)
    torch.cuda.synchronize()
    assert (fa.partial_launches, fa.partial_launches_d32) == (before[0] + 1, before[1] + 1)
    dead = ((lens <= k_offset) | (seq_k == 0))[:, None, None].expand_as(m)
    live = ~dead
    assert (m[dead] == fa.NEG_INF).all() and (l[dead] == 0).all()
    assert (numer.transpose(1, 2)[dead] == 0).all()
    if live.any():
        e_numer, e_m, e_l = fa.flash_attention_partial_reference(q, k, v, lens, k_offset)
        assert bool(((m - e_m).abs() <= 1e-5 * e_m.abs() + 1e-6)[live].all())
        torch.testing.assert_close(l[live], e_l[live], rtol=1e-4, atol=0)
        if dtype == torch.float32:
            rows = live.transpose(1, 2)
            torch.testing.assert_close(numer[rows], e_numer[rows], rtol=1e-5, atol=1e-5)
        else:
            assert _bf16_row_ratio(numer, e_numer, live.transpose(1, 2)) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_head_dim_32_runs_the_kernels(cuda, dtype):
    """A differentiable flash call at D = 32 on the card: one forward (with
    lse), one dq and one dk/dv launch, all at D = 32, no plain path; its
    gradients those of the plain backward on the same out and lse (float32
    rtol/atol 1e-4 against the CPU autograd; bf16 rows as the backward test)."""
    q, k, v, g, lens = _bwd_inputs(cuda, dtype, 200, [200, 77, 0], seed=7, heads=12, head_dim=32)
    live = torch.arange(200, device=cuda)[None, :] < lens[:, None]
    g = g * live[..., None, None]
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    counts = (fa.launches_d32, fa.bwd_dq_launches_d32, fa.bwd_dkv_launches_d32)
    out = fa.flash_attention(*leaves, lens, None)
    out.backward(g)
    torch.cuda.synchronize()
    after = (fa.launches_d32, fa.bwd_dq_launches_d32, fa.bwd_dkv_launches_d32)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 1, 1)
    if dtype == torch.float32:
        cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
        fa.flash_attention(*cpu, lens.cpu(), None).backward(g.cpu())
        for a, e in zip(leaves, cpu):
            torch.testing.assert_close(a.grad.cpu(), e.grad, rtol=1e-4, atol=1e-4)
    else:
        o, lse = fa.flash_attention_lse_cuda(q, k, v, lens, None)
        expected = fa.flash_attention_bwd_reference(q, k, v, lens, o, lse, g, None)
        for a, e in zip(leaves, expected):
            assert _bf16_row_ratio(a.grad, e.float(), live, floor=1e-3) <= 1.0


def test_flash_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 1, 8, device=cuda)
    assert 8 not in fa.FORWARD_HEAD_DIMS
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "seq_q,seq_k,k_offset",
    [(200, 333, 0), (200, 333, 150), (64, 130, 333), (333, 70, 1000), (1, 1, 5)],
)
def test_flash_partial_kernel_matches_plain(cuda, dtype, seq_q, seq_k, k_offset):
    """Offsets with live, partly live and dead blocks, ragged Sq and Sk; row
    2 is empty and, past its length, so is row 1."""
    rng = np.random.default_rng(seq_q + seq_k + k_offset)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(3, s, 3, 64)).astype(np.float32)).to(cuda, dtype)
        for s in (seq_q, seq_k, seq_k)
    )
    lens = torch.tensor([k_offset + seq_k, k_offset + seq_k // 2, 0], dtype=torch.int32, device=cuda)
    before = fa.partial_launches
    numer, m, l = fa.flash_attention_partial(q, k, v, lens, k_offset)
    torch.cuda.synchronize()
    assert fa.partial_launches == before + 1
    e_numer, e_m, e_l = fa.flash_attention_partial_reference(q, k, v, lens, k_offset)
    dead = (lens <= k_offset)[:, None, None].expand_as(m)
    live = ~dead
    assert (m[dead] == fa.NEG_INF).all() and (l[dead] == 0).all()
    assert (numer.transpose(1, 2)[dead] == 0).all()
    assert bool(((m - e_m).abs() <= 1e-5 * e_m.abs() + 1e-6)[live].all())
    torch.testing.assert_close(l[live], e_l[live], rtol=1e-4, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(numer, e_numer, rtol=1e-5, atol=1e-5)
    else:
        rows = live.transpose(1, 2)  # [B, Sq, H]
        assert _bf16_row_ratio(numer, e_numer, rows) <= 1.0


@pytest.mark.parametrize(
    "seq_q,seq_k,k_offset,lens",
    [
        (300, 1000, 0, (1000, 1000)),  # Sq ≠ Sk, every key live
        (777, 500, 400, (650, 0)),  # partly live; a zero-length row
        (129, 256, 512, (512, 300)),  # a dead block: every row ends before it
        (64, 0, 0, (5, 0)),  # an empty KV block
    ],
)
def test_flash_partial_bf16_edges(cuda, seq_q, seq_k, k_offset, lens):
    """The wgmma partial on several 128-row q tiles and 128-key tiles: live,
    partly live and dead blocks and an empty one; dead rows exactly
    (-1e30, 0, 0)."""
    rng = np.random.default_rng(seq_q + seq_k)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(2, s, 12, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
        for s in (seq_q, seq_k, seq_k)
    )
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    numer, m, l = fa.flash_attention_partial(q, k, v, lengths, k_offset)
    torch.cuda.synchronize()
    live_b = (lengths > k_offset) & (seq_k > 0)
    dead = (~live_b)[:, None, None].expand_as(m)
    assert (m[dead] == fa.NEG_INF).all() and (l[dead] == 0).all()
    assert (numer.transpose(1, 2)[dead] == 0).all()
    live = ~dead
    if live.any():  # the plain version needs a key to take its max over
        e_numer, e_m, e_l = fa.flash_attention_partial_reference(q, k, v, lengths, k_offset)
        assert bool(((m - e_m).abs() <= 1e-5 * e_m.abs() + 1e-6)[live].all())
        torch.testing.assert_close(l[live], e_l[live], rtol=1e-4, atol=0)
        assert _bf16_row_ratio(numer, e_numer, live.transpose(1, 2)) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_partial_gradients_on_cuda_match_plain(cuda, dtype):
    """The ring step under grad on the card: the kernel's forward, the plain
    backward (JAX's design). With fixed cotangents for (numer, m, l) the
    gradients are the plain version's autograd on the same inputs (rtol
    1e-5: the same float32 arithmetic); a row past its length gets none."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(2, 96, 2, 64, seed=3)[:1] + _qkv(2, 80, 2, 64, seed=4)[:2])
    lens = torch.tensor([150, 20], dtype=torch.int32, device=cuda)
    weights = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
               for s in ((2, 96, 2, 64), (2, 2, 96), (2, 2, 96))]
    grads = []
    for fn in (fa.flash_attention_partial, fa.flash_attention_partial_reference):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        before = fa.partial_launches
        outs = fn(*leaves, lens, 40)
        assert fa.partial_launches - before == (1 if fn is fa.flash_attention_partial else 0)
        sum((o * w).sum() for o, w in zip(outs, weights)).backward()
        grads.append([x.grad.float() for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert float(grads[0][1][1].abs().max()) == 0.0  # row 1's keys (offset 40 ≥ 20) are dead


def test_ring_gradients_on_cuda_match_cpu(cuda):
    """A ring of 4 shards on one card under grad: 16 partial launches, and
    float32 gradients as the CPU ring's within 1e-4."""
    from verbatim_rag_tpu_torch.ops.ring_attention import ring_attention, shard_sequence
    from verbatim_rag_tpu_torch.parallel import make_mesh

    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 256, 2, 64)).astype(np.float32))
    lens = torch.tensor([200], dtype=torch.int32)
    grads = []
    for device in ("cpu", "cuda"):
        mesh = make_mesh(dp=1, tp=4, devices=[device] * 4)
        leaf = x.clone().to(device).requires_grad_(True)
        before = fa.partial_launches
        out = ring_attention(*(shard_sequence(leaf, mesh) for _ in range(3)), lens, mesh)
        sum((o.float() ** 2).sum() for o in out).backward()
        assert fa.partial_launches - before == (16 if device == "cuda" else 0)
        grads.append(leaf.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-4)


def test_tp_mesh_across_cuda_and_cpu_trains_like_one_device(cuda):
    """A tp = 2 mesh of two distinct devices (the card and the CPU): position
    (0, 0)'s leaves live on the card, position (0, 1)'s on the CPU, and the
    unsharded module on the host. Two steps (float32, plain attention): each
    step's synced gradients, before clipping and gathered, equal the
    single-device step's per tensor within 1e-4 of the tensor's norm (floored
    at 1e-4 of the largest: a key bias's true gradient is 0); a copy left
    stale by the first update would miss by far more (it moves every weight
    by ≈ lr = 1e-3)."""
    from verbatim_rag_tpu_torch.models.config import TrainingConfig, tiny_test_config
    from verbatim_rag_tpu_torch.models.highlighter import HighlighterModel
    from verbatim_rag_tpu_torch.parallel import make_mesh
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer, batch_to_device, sync_grads
    from verbatim_rag_tpu_torch.training.token_dataset import TokenBatch

    config = tiny_test_config()
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(2):
        mask = (np.arange(32)[None, :] < rng.integers(8, 33, size=(4, 1))).astype(np.int32)
        batches.append(TokenBatch(
            input_ids=rng.integers(3, config.vocab_size, size=(4, 32)).astype(np.int32) * mask,
            attention_mask=mask, labels=rng.integers(0, 2, size=(4, 32)).astype(np.int32) * mask,
            label_mask=mask,
        ))
    tc = TrainingConfig(learning_rate=1e-3)
    models = [HighlighterModel(config, torch.Generator().manual_seed(0)).to(cuda) for _ in range(2)]
    meshed = Trainer(models[0], config, tc, mesh=make_mesh(dp=1, tp=2, devices=["cuda", "cpu"]), loss_fn=token_loss)
    single = Trainer(models[1], config, tc, loss_fn=token_loss)
    assert {leaf.device.type for leaf in meshed.model.leaves[0][0].values()} == {"cuda"}
    assert {leaf.device.type for leaf in meshed.model.leaves[0][1].values()} == {"cpu"}
    assert {p.device.type for p in models[0].parameters()} == {"cpu"}
    for step, batch in enumerate(batches):
        grads = []
        for trainer, placed in ((meshed, meshed.batch_to_device(batch)), (single, batch_to_device(batch, cuda))):
            trainer.optimizer.zero_grad()
            token_loss(trainer.model, placed)[0].backward()
            sync_grads(trainer.model, trainer.optimizer)
            if trainer is meshed:
                grads.append(trainer.model.logical_grads(cuda))
            else:
                grads.append({n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None})
            trainer.optimizer.step()
        assert set(grads[0]) == set(grads[1])
        floor = 1e-4 * max(float(g.norm()) for g in grads[1].values())
        for name, want in grads[1].items():
            err = float((grads[0][name] - want).norm()) / max(float(want.norm()), floor)
            assert err <= 1e-4, (step, name, err)


def test_ring_attention_on_cuda_matches_cpu(cuda):
    """A ring of 4 shards on one card: 16 partial launches, float32 output
    as the CPU ring's within 1e-4."""
    from verbatim_rag_tpu_torch.ops.ring_attention import ring_attention, shard_sequence
    from verbatim_rag_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(1)
    x = [torch.from_numpy(rng.normal(size=(2, 256, 2, 64)).astype(np.float32)) for _ in range(3)]
    lens = torch.tensor([256, 100], dtype=torch.int32)
    outs = []
    for device in ("cpu", "cuda"):
        mesh = make_mesh(dp=1, tp=4, devices=[device] * 4)
        before = fa.partial_launches
        got = ring_attention(*(shard_sequence(t, mesh) for t in x), lens, mesh)
        assert fa.partial_launches - before == (16 if device == "cuda" else 0)
        outs.append(torch.cat(got, dim=1).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)


def test_sp_extractor_on_cuda_matches_cpu(cuda):
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, demo_highlighter_config
    from verbatim_rag_tpu_torch.parallel import make_mesh

    text = " ".join(["Solar panels convert sunlight into electricity."] * 60)
    probs = []
    for device in ("cpu", "cuda"):
        extractor = ModelSpanExtractor(
            config=demo_highlighter_config(), device=device, seed=1,
            sp_mesh=make_mesh(dp=1, tp=2, devices=[device] * 2),
        )
        row = extractor._plan("how do solar panels work", text)["rows"][0]
        ids = np.zeros((1, 512), np.int32)
        mask = np.zeros((1, 512), np.int32)
        ids[0, : len(row)] = row
        mask[0, : len(row)] = 1
        before = fa.partial_launches
        probs.append(extractor._forward_probs(ids, mask))
        assert (fa.partial_launches - before) == (8 if device == "cuda" else 0)  # 2 global layers × 2²
    np.testing.assert_allclose(probs[1], probs[0], rtol=1e-4, atol=1e-4)


def _rescore_inputs(b, c, n, m, qm, seed):
    rng = np.random.default_rng(seed)
    sp_ids = rng.integers(0, 3 * max(m, qm), size=(n, m)).astype(np.int32)
    sp_w = rng.random((n, m), dtype=np.float32)
    q_ids = rng.integers(0, 3 * max(m, qm), size=(b, qm)).astype(np.int32)
    q_w = rng.random((b, qm), dtype=np.float32)
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    return cand, sp_ids, sp_w, q_ids, q_w


@pytest.mark.parametrize(
    "b,c,n,m,qm", [(4, 8, 64, 16, 8), (3, 7, 50, 5, 3), (5, 40, 500, 130, 1100), (64, 256, 5000, 128, 32)]
)
def test_rescore_kernel_matches_plain(cuda, b, c, n, m, qm):
    arrays = [torch.from_numpy(a).to(cuda) for a in _rescore_inputs(b, c, n, m, qm, seed=b)]
    before = rs.launches
    got = rs.exact_rescore_dispatch(*arrays)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    expected = rs.exact_rescore_oneshot(*arrays)
    miss = arrays[0] < 0
    assert (got[miss] == -1e30).all()
    torch.testing.assert_close(got[~miss], expected[~miss], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.float16])
def test_rescore_kernel_narrow_forward_index(cuda, ids_dtype, w_dtype):
    cand, sp_ids, sp_w, q_ids, q_w = (
        torch.from_numpy(a).to(cuda) for a in _rescore_inputs(64, 256, 5000, 128, 32, seed=9)
    )
    sp_ids, sp_w = sp_ids.to(ids_dtype), sp_w.to(w_dtype)
    before = rs.launches
    got = rs.exact_rescore_dispatch(cand, sp_ids, sp_w, q_ids, q_w)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    expected = rs.exact_rescore_oneshot(cand, sp_ids, sp_w, q_ids, q_w)
    miss = cand < 0
    assert (got[miss] == -1e30).all()
    torch.testing.assert_close(got[~miss], expected[~miss], rtol=1e-5, atol=1e-6)


def test_rescore_kernel_refuses_narrow_index_dtypes(cuda):
    arrays = [torch.from_numpy(a).to(cuda) for a in _rescore_inputs(2, 4, 10, 4, 2, seed=0)]
    for ids_dtype, w_dtype in ((torch.int8, torch.float32), (torch.int32, torch.bfloat16)):
        narrow = list(arrays)
        narrow[1], narrow[2] = arrays[1].to(ids_dtype), arrays[2].to(w_dtype)
        with pytest.raises(TypeError, match="int32 or int16"):
            rs.exact_rescore_dispatch(*narrow)


def _rescore_edge_inputs(case, seed=0):
    """Inputs of one `RESCORE_EDGES` case (numpy): duplicate ids within a row
    and within a query, query terms of id 0 with nonzero weight, all-pad
    rows (and a non-finite query weight, which stops the kernel skipping
    zero weights), rows past N, and widths off the kernel's 32-slot ranges."""
    b, c, n, m, qm = case["shape"]
    rng = np.random.default_rng(seed)
    vocab = case.get("vocab", 3 * max(m, qm))
    sp_ids = rng.integers(0, vocab, size=(n, m)).astype(np.int32)
    sp_w = rng.random((n, m), dtype=np.float32)
    q_ids = rng.integers(0, vocab, size=(b, qm)).astype(np.int32)
    q_w = rng.random((b, qm), dtype=np.float32)
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    if case.get("dups"):
        sp_ids[:, 1::3] = sp_ids[:, :1]  # one id many times in a row
        q_ids[:, 1::4] = q_ids[:, :1]  # and in a query
        q_ids[:, 2] = 0  # id 0 with a nonzero weight
    if case.get("pad_rows"):
        sp_ids[::2] = 0
        sp_w[::2] = 0.0
        sp_w[1::2, m // 2 :] = 0.0  # pads past the middle of the other rows
    if case.get("inf_weight"):
        q_ids[0, 0], q_w[0, 0] = 0, np.inf  # 0 · inf is NaN on every pad slot of query 0
    if case.get("past_n"):
        cand[:, ::5] = n + rng.integers(0, 3, size=cand[:, ::5].shape)
    return cand, sp_ids, sp_w, q_ids, q_w


RESCORE_EDGES = {
    "duplicate ids in rows and queries": dict(shape=(8, 64, 300, 128, 32), dups=True),
    "all-pad rows": dict(shape=(6, 40, 200, 128, 16), pad_rows=True),
    "all-pad rows, an infinite query weight": dict(shape=(6, 40, 200, 128, 16), pad_rows=True, inf_weight=True),
    "m=5": dict(shape=(5, 33, 100, 5, 3)),
    "m=130 (a partial range of 32 slots)": dict(shape=(5, 33, 100, 130, 40)),
    "m=128": dict(shape=(5, 300, 400, 128, 32)),
    "qm=1": dict(shape=(7, 50, 100, 128, 1)),
    "qm=1100 (three chunks)": dict(shape=(3, 40, 500, 128, 1100), dups=True),
    "rows past N": dict(shape=(4, 60, 100, 64, 16), past_n=True),
    "B=1": dict(shape=(1, 256, 1000, 128, 32)),
}


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("case", sorted(RESCORE_EDGES))
def test_rescore_kernel_edges(cuda, case, ids_dtype):
    """The hash-table kernel on its edges, int32 and int16 ids (float16
    weights with int16 ids): rtol 1e-5 against the plain version, -1e30
    exactly for rows < 0 or ≥ N."""
    cand, sp_ids, sp_w, q_ids, q_w = (
        torch.from_numpy(a).to(cuda) for a in _rescore_edge_inputs(RESCORE_EDGES[case])
    )
    if ids_dtype == torch.int16:
        sp_ids, sp_w = sp_ids.to(torch.int16), sp_w.to(torch.float16)
    before = rs.launches
    got = rs.exact_rescore_dispatch(cand, sp_ids, sp_w, q_ids, q_w)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    miss = (cand < 0) | (cand >= sp_ids.shape[0])
    expected = rs.exact_rescore_oneshot(torch.where(miss, -1, cand), sp_ids, sp_w, q_ids, q_w)
    assert (got[miss] == -1e30).all()
    torch.testing.assert_close(got[~miss], expected[~miss], rtol=1e-5, atol=1e-6, equal_nan=True)
    assert (got[~miss] != 0).any() or RESCORE_EDGES[case].get("pad_rows")
    if RESCORE_EDGES[case].get("inf_weight"):
        assert torch.equal(got[0].isnan(), expected[0].isnan()) and expected[0].isnan().any()


def test_store_on_cuda_matches_cpu(cuda):
    from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    texts = [f"doc {i} about solar wind storage grid {i % 5} {i % 7}" for i in range(300)]
    dense, sparse = HashedBowDenseProvider(64), HashedSparseProvider(4096)
    records = [
        {"id": str(i), "text": t, "dense": d, "sparse": s}
        for i, (t, d, s) in enumerate(zip(texts, dense.embed_batch(texts), sparse.embed_batch(texts)))
    ]
    queries = ["solar grid 3", "wind storage 6", "doc 17"]
    results = []
    for device in ("cpu", "cuda"):
        store = DeviceVectorStore(dense_dim=64, sparse_vocab=4096, sparse_max_nnz=16, device=device)
        store.add_vectors([dict(r) for r in records])
        before = rs.launches
        out = store.query_batch(
            dense_queries=dense.embed_batch(queries), sparse_queries=sparse.embed_batch(queries),
            top_k=5,
        )
        assert (rs.launches > before) == (device == "cuda")
        results.append([[h.id for h in row] for row in out])
    assert results[0] == results[1]


def test_extractor_on_cuda_matches_cpu(cuda):
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, demo_highlighter_config

    text = " ".join(["Solar panels convert sunlight into electricity."] * 60)
    probs = []
    for device in ("cpu", "cuda"):
        extractor = ModelSpanExtractor(config=demo_highlighter_config(), device=device, seed=1)
        plan = extractor._plan("how do solar panels work", text)
        ids = np.zeros((1, 512), np.int32)
        mask = np.zeros((1, 512), np.int32)
        ids[0, : len(plan["rows"][0])] = plan["rows"][0]
        mask[0, : len(plan["rows"][0])] = 1
        before = fa.launches
        probs.append(extractor._forward_probs(ids, mask))
        assert (fa.launches - before) == (4 if device == "cuda" else 0)
    np.testing.assert_allclose(probs[1], probs[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 20, 256])
def test_topk_tie_order_on_cuda(cuda, k):
    from verbatim_rag_tpu_torch.ops.dense import _topk_by_key, topk

    gen = torch.Generator(device=cuda).manual_seed(k)
    scores = torch.randint(-3, 4, (64, 5000), generator=gen, device=cuda).float()
    scores[1, 100:] = -1e30
    scores[2] = 0.25
    vals, pos = topk(scores, k)
    ref_vals, ref_pos = _topk_by_key(scores, k)
    assert torch.equal(pos, ref_pos) and torch.equal(vals, ref_vals)


def _rows_and_queries(n, dims, b, seed, dtype, device):
    """Per arm: unit-norm rows ([N, d] int8 codes + scales, bf16 or float32)
    and float32 queries, made with numpy."""
    from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int8

    rng = np.random.default_rng(seed)
    arms = []
    for d in dims:
        c = rng.normal(size=(n, d)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(device)
        c = torch.from_numpy(c).to(device)
        if dtype == "int8":
            codes, scale = quantize_rows_int8(c)
            arms.append((codes, q, scale))
        else:
            arms.append((c.to(getattr(torch, dtype)), q, None))
    return arms


def _test_mask(n, device):
    mask = torch.ones(n, dtype=torch.bool)
    mask[::7] = False
    mask[np.arange(n) % 128 == 5] = False  # a dead bucket in every block
    return mask.to(device)


def _assert_tables_match(got, expected, q, scores_fn, block, exact):
    """Tables as (values, rows) pairs: bit-equal for int8; bf16 within 2⁻¹⁵
    of |q| with rows equal except in buckets whose two best are that close."""
    (g_vals, g_rows), (e_vals, e_rows) = got, expected
    if exact:
        assert torch.equal(g_vals.view(torch.int32), e_vals.view(torch.int32))
        assert torch.equal(g_rows, e_rows)
        return
    live = e_vals > -1e29
    assert torch.equal(live, g_vals > -1e29)
    tol = 2.0**-15 * q.float().norm(dim=1, keepdim=True).expand_as(g_vals)
    assert bool(((g_vals - e_vals).abs() <= tol)[live].all())
    blocks = scores_fn().reshape(q.shape[0], -1, block // 128, 128)
    top2 = blocks.topk(2, dim=2).values if blocks.shape[2] > 1 else None
    near = torch.zeros_like(live) if top2 is None else (
        (top2[:, :, 0] - top2[:, :, 1]).reshape(q.shape[0], -1).abs() <= tol
    )
    assert bool(((g_rows == e_rows) | ~live | near).all())


def _decode(table, block):
    vals, pos = sec.unpack_table(table)
    cols = torch.arange(table.shape[1], device=table.device)
    return vals, (cols // 128) * block + pos * 128 + cols % 128


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize(
    "n,block,b,dims",
    [(1024, 256, 5, (64, 32)), (3 * 8192, 8192, 70, (384, 768)), (2 * 16384, 16384, 13, (48, 96))],
)
def test_section_kernel_matches_plain(cuda, n, block, b, dims, masked, dtype):
    arms = _rows_and_queries(n, dims, b, seed=n + b, dtype=dtype, device=cuda)
    corpora, queries, scales = zip(*arms)
    scales = scales if dtype == "int8" else ()
    mask = _test_mask(n, cuda) if masked else None
    before = sec.launches
    got = sec.section_bucket_tables(corpora, queries, mask, scales=scales, block_cols=block)
    torch.cuda.synchronize()
    assert sec.launches == before + 1
    expected = sec.section_tables_reference(
        corpora, queries, mask, scales or (None,) * len(arms), block
    )
    for a, (g, e) in enumerate(zip(got, expected)):
        assert g.shape == e.shape == (b, n // block * 128)
        c, q = corpora[a], queries[a]

        def scores(c=c, q=q):
            s = q.to(c.dtype).float() @ c.float().T
            return s if mask is None else torch.where(mask, s, -1e30)

        _assert_tables_match(
            _decode(g, block), _decode(e, block), q, scores, block, exact=dtype == "int8"
        )


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("n,b,d", [(2048, 5, 64), (123 * 8192, 40, 384), (6 * 16384, 130, 768)])
def test_bucket_kernel_matches_plain(cuda, n, b, d, dtype):
    ((corpus, q, scale),) = _rows_and_queries(n, (d,), b, seed=d, dtype=dtype, device=cuda)
    mask = _test_mask(n, cuda)
    before = ft.launches
    got = ft.matmul_bucket_max_v2(corpus, q, mask, scale=scale)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    expected = ft.matmul_bucket_max_v2_reference(corpus, q, mask, scale)
    block = ft.choose_block_rows(n)

    def scores():
        return torch.where(mask, q.to(corpus.dtype).float() @ corpus.float().T, -1e30)

    _assert_tables_match(got, expected, q, scores, block, exact=dtype == "int8")
    assert (got[0][:, 5] <= -1e29).all()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize(
    "n,b,d",
    [
        (9 * 2048, 70, 384),  # blocks of 2048 (16 positions), a ragged batch
        (3 * 8192, 512, 768),  # blocks of 8192; bf16 rows of 1536 B take 64-query tiles
        (2 * 16384, 70, 400),  # blocks of 16384 (128 positions); rows of 400 / 800 B
        (640, 3, 720),  # one block of 5 positions; bf16 rows of 1440 B (odd positions)
        (16384, 130, 64),  # one block of 128 positions; int8 rows of 64 B
        (4096, 70, 1344),  # int8 1344 B: 64 queries, 8 stages; bf16 2688 B: 3 stages
        (128, 9, 1344),  # a block of 128 rows: one position
    ],
)
def test_bucket_v2_wgmma_geometries(cuda, n, b, d, dtype):
    """The int8 / bf16 v2 kernel at every block size, one block of N ≤ 16384,
    ragged batches, row bytes off the 128-byte chunk, both query tiles (two
    warpgroups of 64 queries, or one) and shallow rings; int8 bit-equal, bf16
    within 2⁻¹⁵·|q|; the dead lane 5 of every block is -1e30."""
    ((corpus, q, scale),) = _rows_and_queries(n, (d,), b, seed=n + d, dtype=dtype, device=cuda)
    mask = _test_mask(n, cuda)
    before = ft.launches
    got = ft.matmul_bucket_max_v2(corpus, q, mask, scale=scale)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    expected = ft.matmul_bucket_max_v2_reference(corpus, q, mask, scale)
    block = ft.choose_block_rows(n)

    def scores():
        return torch.where(mask, q.to(corpus.dtype).float() @ corpus.float().T, -1e30)

    _assert_tables_match(got, expected, q, scores, block, exact=dtype == "int8")
    assert (got[0][:, 5::128] <= -1e29).all()


def test_bucket_v2_takes_unaligned_mask_and_scales(cuda):
    """A mask and scales that start off a 16-byte boundary (views into larger
    tensors) give the same int8 table as aligned copies."""
    ((corpus, q, scale),) = _rows_and_queries(4096, (128,), 20, seed=3, dtype="int8", device=cuda)
    big_mask = torch.ones(4097, dtype=torch.bool, device=cuda)
    big_mask[1::9] = False
    big_scale = torch.cat([torch.ones(1, device=cuda), scale.reshape(-1)])
    mask, scale_view = big_mask[1:], big_scale[1:]
    assert mask.data_ptr() % 16 and scale_view.data_ptr() % 16
    got = ft.matmul_bucket_max_v2(corpus, q, mask, scale=scale_view)
    expected = ft.matmul_bucket_max_v2(corpus, q, mask.clone(), scale=scale_view.clone())
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), expected[0].view(torch.int32))
    assert torch.equal(got[1], expected[1])


def test_section_kernel_mixed_arm_kinds(cuda):
    """A float32 dense arm (the FMA walk's 128-query tiles) beside an int8
    sketch arm (the wgmma walk's 128-query tiles): one launch a kind, counted
    as one call."""
    (dense,) = _rows_and_queries(8192, (384,), 100, seed=1, dtype="float32", device=cuda)
    (sketch,) = _rows_and_queries(8192, (768,), 100, seed=2, dtype="int8", device=cuda)
    corpora, queries, scales = zip(dense, sketch)
    mask = _test_mask(8192, cuda)
    before = sec.launches
    got = sec.section_bucket_tables(corpora, queries, mask, scales=scales, block_cols=8192)
    assert sec.launches == before + 1
    expected = sec.section_tables_reference(corpora, queries, mask, scales, 8192)
    torch.cuda.synchronize()
    assert torch.equal(got[1].view(torch.int32), expected[1].view(torch.int32))
    _assert_tables_match(
        _decode(got[0], 8192), _decode(expected[0], 8192), queries[0],
        lambda: torch.where(mask, queries[0] @ corpora[0].T, -1e30), 8192, exact=False,
    )


def _section_case(cuda, n, block, b, dims, dtype, seed, masked=True):
    """Section tables of the kernel against the plain version's (int8
    bit-equal, bf16 within 2⁻¹⁵·|q|)."""
    arms = _rows_and_queries(n, dims, b, seed=seed, dtype=dtype, device=cuda)
    corpora, queries, scales = zip(*arms)
    scales = scales if dtype == "int8" else (None,) * len(arms)
    mask = _test_mask(n, cuda) if masked else None
    before = sec.launches
    got = sec.section_bucket_tables(corpora, queries, mask, scales=scales, block_cols=block)
    torch.cuda.synchronize()
    assert sec.launches == before + 1
    expected = sec.section_tables_reference(corpora, queries, mask, scales, block)
    for g, e, c, q in zip(got, expected, corpora, queries):
        assert g.shape == e.shape == (b, n // block * 128)

        def scores(c=c, q=q):
            s = q.to(c.dtype).float() @ c.float().T
            return s if mask is None else torch.where(mask, s, -1e30)

        _assert_tables_match(
            _decode(g, block), _decode(e, block), q, scores, block, exact=dtype == "int8"
        )
        if masked:  # lane 5 of every block is dead
            assert (g[:, 5::128] <= -1e29).all()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("row_bytes", [16, 144, 1152, 1168, 2944])
def test_section_wgmma_walk_row_widths(cuda, dtype, row_bytes):
    """Rows at the wgmma walk's tile and ring edges (one chunk; past a chunk;
    the widest 128-query tile and the first 64-query one; the widest row, two
    stages), a ragged batch of 70 and a dead bucket in every block."""
    d = row_bytes // (1 if dtype == "int8" else 2)
    _section_case(cuda, 2 * 8192, 8192, 70, (d,), dtype, seed=row_bytes)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_section_wgmma_walk_128_positions_at_1m_rows(cuda, dtype):
    """N = 1,048,576 in blocks of 16384: 128 positions, the pack's limit."""
    _section_case(cuda, 64 * 16384, 16384, 70, (64, 128), dtype, seed=7)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_section_wgmma_walk_three_arms_of_different_widths(cuda, dtype, masked):
    """Three arms in one launch, each with its own maps, tile and ring: 16,
    384 and 1472 columns (bf16 rows of 2944 bytes take 64-query tiles beside
    128-query ones)."""
    _section_case(cuda, 2 * 8192, 8192, 200, (16, 384, 1472), dtype, seed=11, masked=masked)


@pytest.mark.parametrize("row_bytes", [16, 144, 1152, 1168, 2944])
def test_bucket_v1_wgmma_walk_row_widths(cuda, row_bytes):
    """v1 on bf16 rows at the walk's tile and ring edges, a ragged batch of 70
    and a dead bucket (-1e30 at its highest lane)."""
    n, b, d = 16384, 70, row_bytes // 2
    ((corpus, q, _),) = _rows_and_queries(n, (d,), b, seed=row_bytes, dtype="bfloat16", device=cuda)
    mask = _v1_mask(n, cuda)
    before = ft.launches_v1
    got = ft.matmul_bucket_max(corpus, q, mask)
    torch.cuda.synchronize()
    assert ft.launches_v1 == before + 1
    expected = ft.matmul_bucket_max_reference(corpus, q, mask)
    assert _v1_check(got, expected, q, corpus, mask, V1_LIMITS["bfloat16"])
    assert (got[0][:, 5] == -1e30).all() and (got[1][:, 5] == 5 * 128 + 127).all()


#: Rows past 2944 bytes, whose query tile streams through the wgmma walk's
#: ring: int8 at text-embedding-3-large's 3072 and at 4096, bf16 at
#: text-embedding-ada-002's 1536 (3072 bytes).
WIDE_ROWS = [("int8", 3072), ("int8", 4096), ("bfloat16", 1536)]


def _planted_mask_fault_fails(check):
    """A planted fault must fail ``check`` (which asserts)."""
    with pytest.raises(AssertionError):
        check()


@pytest.mark.parametrize("dtype,d", WIDE_ROWS)
def test_section_wgmma_walk_streams_wide_rows(cuda, dtype, d):
    """A wide arm beside a resident 384-column arm in one launch, a ragged
    batch of 200 (a full 128-query tile and a partial one), a dead bucket in
    every block; the planted fault (the kernel run without the mask) fails."""
    before = sec.launches_streamed
    _section_case(cuda, 2 * 8192, 8192, 200, (384, d), dtype, seed=d)
    assert sec.launches_streamed == before + 1
    arms = _rows_and_queries(2 * 8192, (d,), 200, seed=d + 1, dtype=dtype, device=cuda)
    corpora, queries, scales = zip(*arms)
    scales = scales if dtype == "int8" else (None,)
    mask = _test_mask(2 * 8192, cuda)
    expected = sec.section_tables_reference(corpora, queries, mask, scales, 8192)
    faulty = sec.section_tables_cuda(corpora, queries, None, scales, 8192)
    torch.cuda.synchronize()
    scores = lambda: torch.where(  # noqa: E731
        mask, queries[0].to(corpora[0].dtype).float() @ corpora[0].float().T, -1e30
    )
    _planted_mask_fault_fails(
        lambda: _assert_tables_match(
            _decode(faulty[0], 8192), _decode(expected[0], 8192), queries[0], scores, 8192,
            exact=dtype == "int8",
        )
    )


@pytest.mark.parametrize("dtype,d", WIDE_ROWS)
def test_bucket_v2_wgmma_walk_streams_wide_rows(cuda, dtype, d):
    """v2 on wide rows at 4 blocks of 16384, a ragged batch of 200; the
    planted fault (the mask ignored) fails."""
    n = 4 * 16384
    ((corpus, q, scale),) = _rows_and_queries(n, (d,), 200, seed=d + 2, dtype=dtype, device=cuda)
    mask = _test_mask(n, cuda)
    before = ft.launches
    got = ft.matmul_bucket_max_v2(corpus, q, mask, scale=scale)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    expected = ft.matmul_bucket_max_v2_reference(corpus, q, mask, scale)

    def scores():
        return torch.where(mask, q.to(corpus.dtype).float() @ corpus.float().T, -1e30)

    _assert_tables_match(got, expected, q, scores, 16384, exact=dtype == "int8")
    faulty = ft.matmul_bucket_max_v2_cuda(corpus, q, torch.ones_like(mask), scale)
    torch.cuda.synchronize()
    _planted_mask_fault_fails(
        lambda: _assert_tables_match(faulty, expected, q, scores, 16384, exact=dtype == "int8")
    )


def test_bucket_v1_wgmma_walk_streams_wide_rows(cuda):
    """v1 on bf16 rows of 1536 columns (3072 bytes), a ragged batch of 200,
    a dead bucket; the planted fault (the mask ignored) fails."""
    n, b, d = 4 * 16384, 200, 1536
    ((corpus, q, _),) = _rows_and_queries(n, (d,), b, seed=d + 3, dtype="bfloat16", device=cuda)
    mask = _v1_mask(n, cuda)
    before = ft.launches_v1
    got = ft.matmul_bucket_max(corpus, q, mask)
    torch.cuda.synchronize()
    assert ft.launches_v1 == before + 1
    expected = ft.matmul_bucket_max_reference(corpus, q, mask)
    assert _v1_check(got, expected, q, corpus, mask, V1_LIMITS["bfloat16"])
    faulty = ft.matmul_bucket_max_cuda(corpus, q, torch.ones_like(mask))
    torch.cuda.synchronize()
    assert not _v1_check(faulty, expected, q, corpus, mask, V1_LIMITS["bfloat16"])


def test_table_kernels_refuse_other_row_types(cuda):
    q, mask = torch.zeros(2, 32, device=cuda), torch.ones(256, dtype=torch.bool, device=cuda)
    half = torch.zeros(256, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 rows"):
        sec.section_bucket_tables((half,), (q,), None, block_cols=256)
    with pytest.raises(TypeError, match="float32 rows"):
        ft.matmul_bucket_max_v2(half, q, mask)
    # Rows of 2968 bytes, off a 16-byte multiple: taken now (the op copies a
    # packed corpus to a 16-byte pitch once); only a view whose rows the
    # kernels cannot read in place is refused by the launch check.
    ((ragged, q_ragged, _),) = _rows_and_queries(256, (1484,), 2, seed=9, dtype="bfloat16", device=cuda)
    got = ft.matmul_bucket_max_v2(ragged, q_ragged, mask)
    expected = ft.matmul_bucket_max_v2_reference(ragged, q_ragged, mask)
    _assert_tables_match(
        got, expected, q_ragged, lambda: q_ragged.to(ragged.dtype).float() @ ragged.float().T, 256,
        exact=False,
    )
    with pytest.raises(ValueError, match="16-byte multiple"):
        ft.check_kernel_rows(ragged, "bucket")
    with pytest.raises(ValueError, match="no\\s+scale in v1"):
        ft.matmul_bucket_max(torch.zeros(256, 32, dtype=torch.int8, device=cuda), q, mask)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize(
    "n,block,b,dims",
    [
        (2 * 8192, 8192, 200, (4,)),  # d = 4: one partial chunk; 200 queries: a ragged tile
        (2 * 8192, 8192, 130, (768,)),  # 24 chunks, a tile of 2 queries past 128
        (2 * 8192, 8192, 300, (16, 384, 772)),  # three arms, 772: a ragged last chunk
        (64 * 16384, 16384, 40, (36,)),  # 128 positions, the pack's limit
    ],
)
def test_section_fma_walk(cuda, n, block, b, dims, masked):
    """The float32 walk (128-query tiles, rows and queries streamed by TMA)
    at its edges: batches off the tile, d = 4 and 768, three arms in one
    launch, masked or not; within 2⁻¹⁵·|q| of the plain version."""
    _section_case(cuda, n, block, b, dims, "float32", seed=n + b, masked=masked)


def test_section_mixes_float32_and_bf16_arms(cuda):
    """A float32 arm between two bf16 arms: one launch a kind, the float32
    one on the FMA walk, the bf16 ones on the wgmma walk."""
    n, block, b = 2 * 8192, 8192, 150
    arms = [
        _rows_and_queries(n, (d,), b, seed=d, dtype=dtype, device=cuda)[0]
        for d, dtype in ((384, "bfloat16"), (768, "float32"), (64, "bfloat16"))
    ]
    corpora, queries, _ = zip(*arms)
    mask = _test_mask(n, cuda)
    before = sec.launches
    got = sec.section_bucket_tables(corpora, queries, mask, scales=(None,) * 3, block_cols=block)
    torch.cuda.synchronize()
    assert sec.launches == before + 1
    expected = sec.section_tables_reference(corpora, queries, mask, (None,) * 3, block)
    for g, e, c, q in zip(got, expected, corpora, queries):
        _assert_tables_match(
            _decode(g, block), _decode(e, block), q,
            lambda c=c, q=q: torch.where(mask, q.to(c.dtype).float() @ c.float().T, -1e30),
            block, exact=False,
        )


@pytest.mark.parametrize("n,b,d", [(16384, 200, 4), (4 * 2048, 130, 768), (2 * 16384, 129, 68)])
def test_bucket_v2_fma_walk(cuda, n, b, d):
    """v2 on float32 rows: batches off the 128-query tile, d = 4, 68 and
    768; the dead lane 5 of every block is -1e30."""
    ((corpus, q, _),) = _rows_and_queries(n, (d,), b, seed=n + d, dtype="float32", device=cuda)
    mask = _test_mask(n, cuda)
    before = ft.launches
    got = ft.matmul_bucket_max_v2(corpus, q, mask)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    expected = ft.matmul_bucket_max_v2_reference(corpus, q, mask)
    block = ft.choose_block_rows(n)
    _assert_tables_match(
        got, expected, q, lambda: torch.where(mask, q @ corpus.T, -1e30), block, exact=False
    )
    assert (got[0][:, 5::128] <= -1e29).all()


V1_LIMITS = {"bfloat16": 2.0**-15, "float32": 2.0**-18}


def _v1_check(got, expected, q, corpus, mask, limit) -> bool:
    """Whether a v1 table (values, rows) holds to the plain version's: the
    same live entries, -1e30 and the same rows on dead buckets, values within
    limit·|q|, rows equal except in buckets whose two best plain scores lie
    within that."""
    (g_vals, g_rows), (e_vals, e_rows) = got, expected
    live = e_vals > -1e29
    if not torch.equal(live, g_vals > -1e29) or not torch.equal(g_rows[~live], e_rows[~live]):
        return False
    if not bool((g_vals[~live] == -1e30).all()):
        return False
    tol = limit * q.to(corpus.dtype).float().norm(dim=1, keepdim=True).expand_as(g_vals)
    if not bool(((g_vals - e_vals).abs() <= tol)[live].all()):
        return False
    scores = torch.where(mask, q.to(corpus.dtype).float() @ corpus.float().T, -1e30)
    top2 = scores.reshape(q.shape[0], -1, 128).topk(2, dim=2).values
    near = (top2[..., 0] - top2[..., 1]).abs() <= tol
    return bool(((g_rows == e_rows) | near).all())


def _v1_mask(n, device):
    mask = torch.ones(n, dtype=torch.bool)
    mask[::7] = False
    mask[5 * 128 : 6 * 128] = False  # a fully dead bucket
    return mask.to(device)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize(
    "n,b,d", [(2048, 5, 64), (16384, 70, 384), (4 * 16384, 130, 768), (3 * 16384, 512, 384)]
)
def test_bucket_v1_kernel_matches_plain(cuda, n, b, d, dtype):
    ((corpus, q, _),) = _rows_and_queries(n, (d,), b, seed=d + b, dtype=dtype, device=cuda)
    mask = _v1_mask(n, cuda)
    before = ft.launches_v1
    got = ft.matmul_bucket_max(corpus, q, mask)
    torch.cuda.synchronize()
    assert ft.launches_v1 == before + 1
    expected = ft.matmul_bucket_max_reference(corpus, q, mask)
    assert got[0].shape == got[1].shape == (b, n // 128)
    assert _v1_check(got, expected, q, corpus, mask, V1_LIMITS[dtype])
    assert (got[0][:, 5] == -1e30).all() and (got[1][:, 5] == 5 * 128 + 127).all()
    # Planted fault: the kernel run without the mask must fail the check.
    assert not _v1_check(
        ft.matmul_bucket_max(corpus, q, torch.ones_like(mask)), expected, q, corpus, mask,
        V1_LIMITS[dtype],
    )


@pytest.mark.parametrize("n,b,d", [(16384, 200, 4), (2 * 16384, 130, 768)])
def test_bucket_v1_fma_walk(cuda, n, b, d):
    """v1 on float32 rows: batches off the 128-query tile, d = 4 and 768;
    a dead bucket gives (-1e30, its highest lane)."""
    ((corpus, q, _),) = _rows_and_queries(n, (d,), b, seed=d + b, dtype="float32", device=cuda)
    mask = _v1_mask(n, cuda)
    before = ft.launches_v1
    got = ft.matmul_bucket_max(corpus, q, mask)
    torch.cuda.synchronize()
    assert ft.launches_v1 == before + 1
    expected = ft.matmul_bucket_max_reference(corpus, q, mask)
    assert _v1_check(got, expected, q, corpus, mask, V1_LIMITS["float32"])
    assert (got[0][:, 5] == -1e30).all() and (got[1][:, 5] == 5 * 128 + 127).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bucket_v1_kernel_exact_ties(cuda, dtype):
    """Small-integer rows with duplicates inside buckets: bit-equal, highest
    lane; the kernel run on each bucket's lanes reversed (ties to the lowest
    lane, mapped back) must differ."""
    n, b, d = 4 * 16384, 77, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    corpus = torch.randint(-2, 3, (n, d), generator=gen, device=cuda).float()
    q = torch.randint(-2, 3, (b, d), generator=gen, device=cuda).float()
    copies = torch.randint(0, 128, (n // 128, 6), generator=gen, device=cuda)
    rows = copies + torch.arange(0, n, 128, device=cuda)[:, None]
    corpus[rows] = corpus[rows[:, :1]]
    corpus = corpus.to(getattr(torch, dtype))
    mask = _v1_mask(n, cuda)
    got = ft.matmul_bucket_max(corpus, q, mask)
    expected = ft.matmul_bucket_max_reference(corpus, q, mask)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), expected[0].view(torch.int32))
    assert torch.equal(got[1], expected[1])
    flip = lambda x: x.reshape(-1, 128, *x.shape[1:]).flip(1).reshape(x.shape)  # noqa: E731
    vals, rrows = ft.matmul_bucket_max(flip(corpus), q, flip(mask))
    lowest = (rrows // 128) * 128 + 127 - rrows % 128
    live = got[0] > -1e29
    assert torch.equal(vals, got[0]) and not torch.equal(lowest[live], got[1][live])


@pytest.mark.parametrize("impl", ["auto", "bucket"])
def test_int8_store_on_cuda_matches_cpu(cuda, impl):
    from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    texts = [f"doc {i} about solar wind storage grid {i % 5} {i % 7}" for i in range(300)]
    dense, sparse = HashedBowDenseProvider(64), HashedSparseProvider(4096)
    records = [
        {"id": str(i), "text": t, "dense": d, "sparse": s}
        for i, (t, d, s) in enumerate(zip(texts, dense.embed_batch(texts), sparse.embed_batch(texts)))
    ]
    queries = ["solar grid 3", "wind storage 6", "doc 17"]
    results = []
    for device in ("cpu", "cuda"):
        store = DeviceVectorStore(
            dense_dim=64, sparse_vocab=4096, sparse_max_nnz=16, device=device,
            dense_dtype="int8", sketch_dtype="int8", candidate_impl=impl,
        )
        store.add_vectors([dict(r) for r in records])
        counter = ft if impl == "bucket" else sec
        before = counter.launches
        out = store.query_batch(
            dense_queries=dense.embed_batch(queries), sparse_queries=sparse.embed_batch(queries),
            top_k=5, search_params={"rescore_depth": 64},
        )
        assert (counter.launches > before) == (device == "cuda")
        results.append([[h.id for h in row] for row in out])
    assert results[0] == results[1]


@pytest.mark.parametrize("impl", ["section", "bucket"])
def test_float32_narrow_index_store_on_cuda_matches_cpu(cuda, impl):
    """dense float32, int16 ids, float16 weights: the float32 table arms and
    the narrow rescore on the card give the CPU store's rows."""
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    rng = np.random.default_rng(4)
    n, d, m, vocab = 600, 64, 16, 4096
    dense = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(1, vocab, size=(n, m)).astype(np.int32)
    weights = rng.random((n, m), dtype=np.float32)
    records = [
        {"id": str(i), "text": str(i), "dense": dense[i], "sparse_arrays": (ids[i], weights[i])}
        for i in range(n)
    ]
    q_dense = dense[:5] + 0.3 * rng.normal(size=(5, d)).astype(np.float32)
    q_ids, q_w = ids[:5, :8].copy(), rng.random((5, 8), dtype=np.float32)
    results = []
    for device in ("cpu", "cuda"):
        store = DeviceVectorStore(
            dense_dim=d, sparse_vocab=vocab, sparse_max_nnz=m, device=device,
            dense_dtype="float32", sparse_ids_dtype="int16", sparse_weight_dtype="float16",
        )
        store.candidate_impl = impl
        store.add_vectors(records)
        counter = ft if impl == "bucket" else sec
        before, rs_before = counter.launches, rs.launches
        out = store.query_batch(
            dense_queries=q_dense, sparse_queries=(q_ids, q_w), top_k=5,
            search_params={"rescore_depth": 64},
        )
        assert (counter.launches > before) == (rs.launches > rs_before) == (device == "cuda")
        results.append([[h.id for h in row] for row in out])
    assert results[0] == results[1]


TRAIN_OVERRIDES = dict(
    vocab_size=512, hidden_size=128, num_heads=2, num_layers=3, intermediate_size=128,
    max_position_embeddings=4096, position_embedding_type="rope", norm_location="pre",
    activation="geglu", use_bias=False, final_norm=True, type_vocab_size=0,
    first_layer_no_attn_norm=True, layer_norm_eps=1e-5, local_attention_window=16,
    use_flash_attention=True,
)


def _token_batch(config, n=4, seed=0):
    from verbatim_rag_tpu_torch.models import HashTokenizer
    from verbatim_rag_tpu_torch.training.token_dataset import (
        TokenDatasetEncoder,
        make_synthetic_token_data,
    )

    encoder = TokenDatasetEncoder(HashTokenizer(config.vocab_size), max_length=128, doc_stride=32)
    return encoder.encode(make_synthetic_token_data(n, seed=seed))


@pytest.mark.parametrize("compute_dtype,rtol", [("float32", 1e-3), ("bfloat16", 5e-2)])
def test_train_step_grads_on_cuda_match_cpu(cuda, compute_dtype, rtol):
    """One loss + backward of the token highlighter (2 heads of 64, global
    and local layers) on the card and on the CPU from the same weights: the
    card runs 3 forward (lse), 3 dq and 3 dk/dv launches; each parameter's
    gradient within ‖g_cuda − g_cpu‖/‖g_cpu‖ ≤ 1e-3 in float32 and 5e-2 in
    bf16 (bf16 operands rounded at other points: the kernels round P and dS
    to bf16, the plain versions keep them float32)."""
    from verbatim_rag_tpu_torch.models import init_highlighter_params, tiny_test_config
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import batch_to_device

    config = tiny_test_config(**TRAIN_OVERRIDES, compute_dtype=compute_dtype)
    batch = _token_batch(config)
    grads, losses = [], []
    for device in ("cpu", "cuda"):
        model = init_highlighter_params(config, seed=1, device=device)
        counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        loss, _ = token_loss(model, batch_to_device(batch, device))
        loss.backward()
        launched = (fa.launches - counts[0], fa.bwd_dq_launches - counts[1], fa.bwd_dkv_launches - counts[2])
        assert launched == ((3, 3, 3) if device == "cuda" else (0, 0, 0))
        losses.append(float(loss))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None})
    np.testing.assert_allclose(losses[1], losses[0], rtol=rtol)
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        err = float((grads[1][name] - g).norm() / g.norm().clamp(min=1e-30))
        assert err <= rtol, (name, err)


def test_trainer_on_cuda_serves_its_checkpoint(cuda, tmp_path):
    """Two Trainer steps on the card, then `ModelSpanExtractor(model_path=...)`
    on the saved checkpoint gives the trained model's probabilities."""
    from verbatim_rag_tpu_torch.models import (
        ModelSpanExtractor,
        init_highlighter_params,
        tiny_test_config,
        token_relevance_probs,
    )
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer

    config = tiny_test_config(**TRAIN_OVERRIDES, compute_dtype="bfloat16")
    model = init_highlighter_params(config, seed=2, device="cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, config, output_dir=str(tmp_path), loss_fn=token_loss)
    trainer.train([_token_batch(config, seed=s) for s in (3, 4)], num_epochs=1)
    assert len(trainer.steps) == 2 and trainer.oom_skips == 0
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in trainer.steps)
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    served = ModelSpanExtractor(model_path=str(tmp_path / "final"), device="cuda")
    batch = _token_batch(config, seed=5)
    ids, mask = (torch.from_numpy(x).cuda() for x in (batch.input_ids, batch.attention_mask))
    with torch.no_grad():
        expected = token_relevance_probs(model, ids, mask)
        got = token_relevance_probs(served.model, ids, mask)
    assert torch.equal(got, expected)


def test_tiny_train_step_runs_on_the_card(cuda, tmp_path):
    """``train --tiny`` on the card: `tiny_test_config` (4 heads of 8, flash
    off as in the JAX package) trains through the plain attention, with no
    flash launch, and writes a checkpoint the extractor serves."""
    import json

    from verbatim_rag_tpu_torch.models import ModelSpanExtractor
    from verbatim_rag_tpu_torch.training import train as train_cli
    from verbatim_rag_tpu_torch.training.token_dataset import make_synthetic_token_data

    data = tmp_path / "data.json"
    data.write_text(json.dumps([
        {"question": e.question, "context": e.context, "answers": [list(s) for s in e.spans], "split": e.split}
        for e in make_synthetic_token_data(10, seed=1)
    ]))
    before = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    argv = ["--data-path", str(data), "--tiny", "--mode", "token", "--device", "cuda", "--epochs", "1",
            "--batch-size", "4", "--max-seq-length", "64", "--output-dir", str(tmp_path / "out")]
    assert train_cli.main(argv) == 0
    assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == before
    extractor = ModelSpanExtractor(model_path=str(tmp_path / "out" / "final"), device="cuda")
    assert next(extractor.model.parameters()).is_cuda


def test_section_kernel_three_int8_arms(cuda):
    """The 3-way section launch: three int8 arms (dense 384, SPLADE sketch
    768, BM25 sketch 768) in one call, tables bit-equal to the plain
    version's."""
    from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int8

    gen = torch.Generator(device="cuda").manual_seed(5)
    n, batch = 4 * 8192, 70
    corpora, scales, queries = [], [], []
    for d in (384, 768, 768):
        codes, scale = quantize_rows_int8(torch.randn(n, d, generator=gen, device="cuda"))
        corpora.append(codes)
        scales.append(scale)
        queries.append(torch.randn(batch, d, generator=gen, device="cuda"))
    mask = torch.rand(n, generator=gen, device="cuda") > 0.05
    before = sec.launches
    got = sec.section_tables_cuda(corpora, queries, mask, scales, 8192)
    assert sec.launches == before + 1
    expected = sec.section_tables_reference(corpora, queries, mask, scales, 8192)
    for g, e in zip(got, expected):
        assert torch.equal(g.view(torch.int32), e.view(torch.int32))


def test_rescore_kernel_at_the_bm25_width(cuda):
    """The BM25 arm's rescore: m=256 int32 / float32 slots over a 2^17
    vocabulary, 64 query terms, missing candidates; rtol 1e-5 against the
    plain version, −1e30 exactly where a candidate is missing."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    n, m, b, c, qm, vocab = 50_000, 256, 64, 256, 64, 1 << 17
    ids = torch.randint(1, vocab, (n, m), generator=gen, device="cuda", dtype=torch.int32)
    w = torch.rand((n, m), generator=gen, device="cuda")
    nnz = torch.randint(1, m + 1, (n, 1), generator=gen, device="cuda")
    pad = torch.arange(m, device="cuda")[None, :] >= nnz
    ids[pad], w[pad] = 0, 0.0
    cand = torch.randint(0, n, (b, c), generator=gen, device="cuda", dtype=torch.int32)
    cand[:, -7:] = -1
    q_ids = torch.randint(1, vocab, (b, qm), generator=gen, device="cuda", dtype=torch.int32)
    q_ids[:, : qm // 2] = ids[cand[:, : qm // 2].clamp(min=0).long(), torch.arange(qm // 2, device="cuda")]
    q_w = torch.rand((b, qm), generator=gen, device="cuda")
    got = rs.exact_rescore_cuda(cand, ids, w, q_ids, q_w)
    expected = rs.exact_rescore_oneshot(cand, ids, w, q_ids, q_w)
    valid = cand >= 0
    assert torch.equal(got[~valid], torch.full_like(got[~valid], -1e30))
    torch.testing.assert_close(got[valid], expected[valid], rtol=1e-5, atol=1e-6)
    assert float((got[valid] > 0).float().mean()) > 0.05


def test_hf_loaded_full_width_extractor_equals_the_native_one(cuda, tmp_path):
    """A full-width ModernBERT-base trainer checkpoint staged for the Hub;
    its config.json, model.safetensors and a tokenizer.json alone load
    through the HF branch on the card: weights and token probabilities equal
    the native checkpoint's exactly (the conversion is float32 transposes and
    splits), the flash forward launches once a layer, and every span is
    verbatim."""
    import shutil

    from verbatim_rag_tpu_torch.models import (
        HashTokenizer,
        ModelSpanExtractor,
        init_highlighter_params,
        modernbert_base_config,
        token_relevance_probs,
    )
    from verbatim_rag_tpu_torch.models.tokenizer import train_wordpiece_tokenizer
    from verbatim_rag_tpu_torch.training.trainer import Trainer
    from verbatim_rag_tpu_torch.utils.upload_to_hub import jax_checkpoint_to_hf_dir

    config = modernbert_base_config()
    model = init_highlighter_params(config, seed=6, device="cuda")
    native = tmp_path / "native"
    Trainer(model, config, tokenizer=HashTokenizer(config.vocab_size)).save_checkpoint(str(native))
    jax_checkpoint_to_hf_dir(str(native), str(tmp_path / "staged"))
    hf = tmp_path / "hf"
    hf.mkdir()
    for name in ("config.json", "model.safetensors"):
        shutil.copy(tmp_path / "staged" / name, hf / name)
    context = " ".join(
        f"Solar panel {i} converts sunlight into electricity at {10 + i % 15} percent efficiency."
        for i in range(120)
    )
    train_wordpiece_tokenizer(hf / "tokenizer.json", [context], vocab_size=2000)
    served = ModelSpanExtractor(model_path=str(hf), device="cuda", threshold=0.5, min_span_chars=5)
    reference = ModelSpanExtractor(model_path=str(native), device="cuda")
    for key, value in reference.model.state_dict().items():
        assert torch.equal(served.model.state_dict()[key], value), key
    plan = served._plan("How efficient are solar panels?", context)
    row = plan["rows"][0]
    ids = torch.tensor([row], dtype=torch.int32, device=cuda)
    mask = torch.ones_like(ids)
    before = fa.launches
    with torch.no_grad():
        got = token_relevance_probs(served.model, ids, mask)
    assert fa.launches == before + config.num_layers
    with torch.no_grad():
        expected = token_relevance_probs(reference.model, ids, mask)
    assert torch.equal(got, expected)
    spans = served.process("How efficient are solar panels?", context)
    assert all(0 <= s < e <= len(context) for s, e in spans)


def test_d32_cross_encoder_flash_matches_plain(cuda, monkeypatch):
    """The cross-encoder at MiniLM width with flash on (head dim 32), 50
    passages in one call: the kernel on each layer's own q/k/v against plain
    attention, each live row to its bf16 limit; the pooled state (before the
    score's dot, whose terms cancel) against the same weights through plain
    attention, each row to 2e-2 of its largest |value|; the scores within
    2e-2 of the largest. A planted fault that hides the passages from the
    kernel (lengths cut to 4 keys) must fail the pooled check."""
    import dataclasses

    from verbatim_rag_tpu_torch.models import JaxCrossEncoder, minilm_config
    from verbatim_rag_tpu_torch.models import encoder as encoder_module

    config = minilm_config(use_flash_attention=True)
    flash = JaxCrossEncoder(config=config, seed=0, device="cuda")
    plain = JaxCrossEncoder(params=flash.model.state_dict(),
                            config=dataclasses.replace(config, use_flash_attention=False), device="cuda")
    question = "How efficient are solar panels?"
    texts = [f"passage {i} about " + "solar wind storage grids " * (3 + i % 40) for i in range(50)]
    before = fa.launches_d32
    got = flash.score(question, texts)
    assert fa.launches_d32 == before + config.num_layers
    expected = plain.score(question, texts)
    assert fa.launches_d32 == before + config.num_layers
    assert got.shape == (50,) and np.isfinite(got).all()
    limit = 2e-2 * float(np.abs(expected).max())
    assert float(np.abs(got - expected).max()) <= limit

    captured = []

    def capture(q, k, v, lengths, window=None):
        captured.append((q, k, v, lengths, window))
        return fa.flash_attention(q, k, v, lengths, window)

    monkeypatch.setattr(encoder_module, "flash_attention", capture)
    got_pooled = torch.from_numpy(flash.pooled(question, texts))
    assert len(captured) == config.num_layers
    for q, k, v, lengths, window in captured:
        assert q.shape[0] == 50 and q.shape[2:] == (12, 32)
        live = torch.arange(q.shape[1], device=cuda)[None, :] < lengths[:, None]
        out = fa.flash_attention_cuda(q, k, v, lengths, window)
        assert _bf16_row_ratio(out, fa.attention_reference(q, k, v, lengths, window), live) <= 1.0
    plain_pooled = torch.from_numpy(plain.pooled(question, texts))
    rows = torch.ones(50, dtype=torch.bool)
    assert _bf16_row_ratio(got_pooled, plain_pooled, rows) <= 1.0
    monkeypatch.setattr(encoder_module, "flash_attention",
                        lambda q, k, v, lengths, window=None: fa.flash_attention(
                            q, k, v, torch.clamp(lengths, max=4), window))
    assert _bf16_row_ratio(torch.from_numpy(flash.pooled(question, texts)), plain_pooled, rows) > 1.0


def _hashed_records(n):
    from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider

    texts = [f"doc {i} about solar wind storage grid {i % 5} {i % 7}" for i in range(n)]
    dense, sparse = HashedBowDenseProvider(64), HashedSparseProvider(4096)
    records = [
        {"id": str(i), "text": t, "dense": d, "sparse": s}
        for i, (t, d, s) in enumerate(zip(texts, dense.embed_batch(texts), sparse.embed_batch(texts)))
    ]
    queries = ["solar grid 3", "wind storage 6", "doc 17"]
    return records, dict(dense_queries=dense.embed_batch(queries), sparse_queries=sparse.embed_batch(queries))


@pytest.mark.parametrize("impl,counter,per_shard", [("xla", rs, 1), ("section", sec, 1), ("bucket", ft, 2)])
def test_mesh_store_on_cuda_matches_cpu_mesh(cuda, impl, counter, per_shard):
    """A mesh store of two shards on the card launches each kernel once per
    shard (bucket: once per shard and arm) and answers as the same mesh on
    the CPU (the plain versions)."""
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
    from verbatim_rag_tpu_torch.parallel import RowSharded, make_mesh

    records, query = _hashed_records(300)
    results = []
    for device in ("cpu", cuda):
        store = DeviceVectorStore(
            dense_dim=64, sparse_vocab=4096, sparse_max_nnz=16, block=2 * 8192,
            dense_dtype="int8", sketch_dtype="int8", candidate_impl=impl,
            mesh=make_mesh(dp=2, devices=[device] * 2),
        )
        store.add_vectors([dict(r) for r in records])
        store.flush()
        assert isinstance(store._dense, RowSharded) and store._dense.device.type == torch.device(device).type
        before = counter.launches
        out = store.query_batch(top_k=5, search_params={"rescore_depth": 64}, **query)
        assert counter.launches - before == (2 * per_shard if device == cuda else 0)
        results.append([[h.id for h in row] for row in out])
    assert results[0] == results[1]


def test_int4_store_on_cuda_matches_cpu(cuda):
    """The int4 tier on the card (unpack + `torch._int_mm`, the rescore
    kernel) answers as on the CPU, and never enters the bucket kernel."""
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    records, query = _hashed_records(300)
    results = []
    for device in ("cpu", cuda):
        store = DeviceVectorStore(
            dense_dim=64, sparse_vocab=4096, sparse_max_nnz=16, device=device,
            dense_dtype="int4", sketch_dtype="int4", candidate_impl="bucket",
        )
        store.add_vectors([dict(r) for r in records])
        before = ft.launches, rs.launches
        out = store.query_batch(top_k=5, search_params={"rescore_depth": 64}, **query)
        assert ft.launches == before[0] and rs.launches - before[1] == (device == cuda)
        results.append([[h.id for h in row] for row in out])
    assert results[0] == results[1]


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_row_quantization_on_cuda_is_bit_equal_to_cpu(cuda, tier):
    """Stored rows quantize on the card bit-equal to the CPU (and so to the
    JAX package's numpy): the per-row scale is a true division, not the
    reciprocal multiply CUDA takes for a Python-scalar divisor."""
    from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int4, quantize_rows_int8

    quantize = quantize_rows_int4 if tier == "int4" else quantize_rows_int8
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(65536, 384)).astype(np.float32))
    for got, want in zip(quantize(x.to(cuda)), quantize(x)):
        assert torch.equal(got.cpu(), want)


# -- rows of any width (a 16-byte row pitch) and batches past the grid ------------------

#: Widths off a 16-byte multiple: int8 300 (GloVe's 300 dims), bf16 300,
#: float32 301, and rows past 2944 bytes that stream the query tile (int8
#: 3000, bf16 1500).
RAGGED_WIDTHS = [("int8", 300), ("bfloat16", 300), ("float32", 301), ("int8", 3000), ("bfloat16", 1500)]


def _pitched_arms(n, dims, b, seed, dtype, device, layout):
    """`_rows_and_queries` with each arm's rows at the store's 16-byte pitch
    (``layout="pitched"``) or packed."""
    arms = _rows_and_queries(n, dims, b, seed=seed, dtype=dtype, device=device)
    if layout == "packed":
        return arms
    out = []
    for c, q, s in arms:
        view = ft.pitched_zeros(c.shape[0], c.shape[1], c.dtype, device)
        view.copy_(c)
        assert ft.is_pitched(view) and not view.is_contiguous()
        out.append((view, q, s))
    return out


@pytest.mark.parametrize("layout", ["pitched", "packed"])
@pytest.mark.parametrize("dtype,d", RAGGED_WIDTHS)
def test_section_kernel_at_ragged_widths(cuda, dtype, d, layout):
    """Two arms of a ragged width in one launch against the plain version
    (int8 bit-equal), a ragged batch of 200, a dead lane; a pitched corpus
    is read in place, a packed one copied once; the planted fault (the mask
    ignored) fails the check."""
    n, block, b = 2 * 8192, 8192, 200
    arms = _pitched_arms(n, (d, d), b, d + 7, dtype, cuda, layout)
    corpora, queries, scales = zip(*arms)
    scales = scales if dtype == "int8" else (None, None)
    mask = _test_mask(n, cuda)
    copies, before = ft.corpus_copies, sec.launches
    got = sec.section_bucket_tables(corpora, queries, mask, scales=scales, block_cols=block)
    torch.cuda.synchronize()
    assert sec.launches == before + 1
    assert ft.corpus_copies == copies + (2 if layout == "packed" else 0)
    expected = sec.section_tables_reference(corpora, queries, mask, scales, block)
    for g, e, c, q in zip(got, expected, corpora, queries):
        def scores(c=c, q=q):
            return torch.where(mask, q.to(c.dtype).float() @ c.float().T, -1e30)

        _assert_tables_match(_decode(g, block), _decode(e, block), q, scores, block, dtype == "int8")
        assert (g[:, 5::128] <= -1e29).all()
    faulty = sec.section_tables_cuda(corpora, queries, None, scales, block)
    torch.cuda.synchronize()
    _planted_mask_fault_fails(lambda: _assert_tables_match(
        _decode(faulty[0], block), _decode(expected[0], block), queries[0],
        lambda: torch.where(mask, queries[0].to(corpora[0].dtype).float() @ corpora[0].float().T, -1e30),
        block, dtype == "int8",
    ))


@pytest.mark.parametrize("layout", ["pitched", "packed"])
@pytest.mark.parametrize("dtype,d", RAGGED_WIDTHS)
def test_bucket_v2_kernel_at_ragged_widths(cuda, dtype, d, layout):
    """v2 on a ragged width against the plain version (int8 bit-equal) at 4
    blocks of 16384, a ragged batch of 130; the planted fault (the mask
    ignored) fails."""
    n = 4 * 16384
    ((corpus, q, scale),) = _pitched_arms(n, (d,), 130, d + 8, dtype, cuda, layout)
    mask = _test_mask(n, cuda)
    before = ft.launches
    got = ft.matmul_bucket_max_v2(corpus, q, mask, scale=scale)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    expected = ft.matmul_bucket_max_v2_reference(corpus, q, mask, scale)

    def scores():
        return torch.where(mask, q.to(corpus.dtype).float() @ corpus.float().T, -1e30)

    _assert_tables_match(got, expected, q, scores, 16384, exact=dtype == "int8")
    faulty = ft.matmul_bucket_max_v2_cuda(corpus, q, torch.ones_like(mask), scale)
    torch.cuda.synchronize()
    _planted_mask_fault_fails(
        lambda: _assert_tables_match(faulty, expected, q, scores, 16384, exact=dtype == "int8")
    )


@pytest.mark.parametrize("layout", ["pitched", "packed"])
@pytest.mark.parametrize("dtype,d", [w for w in RAGGED_WIDTHS if w[0] != "int8"])
def test_bucket_v1_kernel_at_ragged_widths(cuda, dtype, d, layout):
    """v1 on bf16 and float32 rows of a ragged width against the plain
    version, a dead bucket; the planted fault (the mask ignored) fails."""
    n = 2 * 16384
    ((corpus, q, _),) = _pitched_arms(n, (d,), 70, d + 9, dtype, cuda, layout)
    mask = _v1_mask(n, cuda)
    before = ft.launches_v1
    got = ft.matmul_bucket_max(corpus, q, mask)
    torch.cuda.synchronize()
    assert ft.launches_v1 == before + 1
    expected = ft.matmul_bucket_max_reference(corpus, q, mask)
    assert _v1_check(got, expected, q, corpus, mask, V1_LIMITS[dtype])
    assert (got[0][:, 5] == -1e30).all()
    faulty = ft.matmul_bucket_max_cuda(corpus, q, torch.ones_like(mask))
    torch.cuda.synchronize()
    assert not _v1_check(faulty, expected, q, corpus, mask, V1_LIMITS[dtype])


def test_pitched_rows_reach_the_kernels_without_a_copy(cuda, monkeypatch):
    """The corpus pointer each wrapper hands its launch is the pitched view's
    own (no copy), for section, v2 and v1."""
    passed = []
    for module in (sec, ft):
        original = module.kernel_operands

        def recording(corpus, q, what, original=original):
            operands = original(corpus, q, what)
            passed.append((corpus.data_ptr(), operands[0].data_ptr()))
            return operands

        monkeypatch.setattr(module, "kernel_operands", recording)
    ((c8, q8, s8),) = _pitched_arms(16384, (300,), 20, 1, "int8", cuda, "pitched")
    ((cb, qb, _),) = _pitched_arms(16384, (300,), 20, 2, "bfloat16", cuda, "pitched")
    mask = _test_mask(16384, cuda)
    copies = ft.corpus_copies
    sec.section_tables_cuda((c8, cb), (q8, qb), mask, (s8, None), 8192)
    ft.matmul_bucket_max_v2_cuda(c8, q8, mask, s8)
    ft.matmul_bucket_max_cuda(cb, qb, mask)
    torch.cuda.synchronize()
    assert ft.corpus_copies == copies
    assert passed == [(c8.data_ptr(),) * 2, (cb.data_ptr(),) * 2, (c8.data_ptr(),) * 2, (cb.data_ptr(),) * 2]


def test_ragged_store_on_the_card_equals_its_zero_padded_twin(cuda):
    """A 300-d int8 store on the card ("auto" → section) answers as its twin
    at 304 columns, bit for bit, and its query batch copies no corpus."""
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    rng = np.random.default_rng(3)
    n = 3000
    rows = (rng.integers(-16, 17, size=(n, 300)) / 16).astype(np.float32)  # exact norms
    ids = rng.integers(1, 4096, size=(n, 8)).astype(np.int32)
    w = rng.random((n, 8), dtype=np.float32)
    q = (rng.integers(-16, 17, size=(64, 300)) / 16).astype(np.float32)
    q_ids = np.ascontiguousarray(ids[:64, :6])
    q_w = rng.random((64, 6), dtype=np.float32)
    answers = []
    for cols in (300, 304):
        store = DeviceVectorStore(dense_dim=cols, sparse_vocab=4096, sparse_max_nnz=8, projection_dim=100,
                                  dense_dtype="int8", sketch_dtype="int8")
        padded = np.zeros((n, cols), np.float32)
        padded[:, :300] = rows
        store.add_vectors([
            {"id": str(i), "dense": padded[i], "sparse_arrays": (ids[i], w[i])} for i in range(n)
        ])
        store.flush()
        assert store.candidate_impl == "section" and store._dense.is_cuda
        qp = np.zeros((64, cols), np.float32)
        qp[:, :300] = q
        copies, before = ft.corpus_copies, sec.launches
        out = store.query_batch(dense_queries=qp, sparse_queries=(q_ids, q_w), top_k=10)
        assert sec.launches == before + 1 and ft.corpus_copies == copies
        answers.append([[(h.id, h.score) for h in r] for r in out])
    assert answers[0] == answers[1] and all(len(r) == 10 for r in answers[0])


def test_int8_dots_on_a_pitched_view(cuda):
    """The "xla" path's int8 product (`torch._int_mm` where its shape rules
    hold) on a pitched view of 24 columns (rows of 32 bytes) equals the
    product on the packed rows."""
    from verbatim_rag_tpu_torch.ops.dense import int8_dots

    rng = np.random.default_rng(4)
    codes = torch.from_numpy(rng.integers(-127, 128, size=(4096, 24)).astype(np.int8)).to(cuda)
    qi = torch.from_numpy(rng.integers(-127, 128, size=(64, 24)).astype(np.int8)).to(cuda)
    view = ft.pitched_zeros(4096, 24, torch.int8, cuda)
    view.copy_(codes)
    assert view.stride(0) == 32
    assert torch.equal(int8_dots(qi, view), int8_dots(qi, codes))


#: batch × heads = 65,544 at MiniLM's 12 heads of 32: one past the grid's
#: 65,535 rows on y plus eight, so two launches, the second of one row.
GRID_BATCH, GRID_HEADS, GRID_SEQ = 5462, 12, 64


def _grid_inputs(cuda, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, g = (
        torch.randn(GRID_BATCH, GRID_SEQ, GRID_HEADS, 32, generator=gen, device=cuda, dtype=torch.bfloat16)
        for _ in range(4)
    )
    lens = torch.randint(1, GRID_SEQ + 1, (GRID_BATCH,), generator=gen, device=cuda, dtype=torch.int32)
    lens[1] = 0
    lens[-1] = GRID_SEQ
    return q, k, v, g, lens


#: Batch rows checked against the plain versions: both sides of the split.
GRID_ROWS = slice(GRID_BATCH - 70, GRID_BATCH)


def test_flash_forward_and_backward_past_the_grid_limit(cuda):
    """The forward (with lse) and the FA2 backward at batch × heads = 65,544
    launch twice each, inside one autograd call; the rows on both sides of
    the split hold to the plain versions as the bf16 checks hold them."""
    q, k, v, g, lens = _grid_inputs(cuda)
    live = torch.arange(GRID_SEQ, device=cuda)[None, :] < lens[:, None]
    before = (fa.launches, fa.launches_d32, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, lens)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_d32, fa.bwd_dq_launches, fa.bwd_dkv_launches) == tuple(
        x + 2 for x in before
    )
    sl = GRID_ROWS
    ref = fa.attention_reference(q[sl], k[sl], v[sl], lens[sl])
    assert _bf16_row_ratio(out[sl].detach(), ref, live[sl]) <= 1.0
    _, lse = fa.attention_lse_reference(q[sl], k[sl], v[sl], lens[sl])
    refs = fa.flash_attention_bwd_reference(q[sl], k[sl], v[sl], lens[sl], out[sl].detach(), lse, g[sl])
    for got, exp in zip(grads, refs):
        assert _bf16_row_ratio(got[sl], exp.float(), live[sl], floor=1e-3) <= 1.0
    assert (out[1] == 0).all()


def test_flash_partial_past_the_grid_limit(cuda):
    """The ring step's partial at batch × heads = 65,544: two launches, the
    rows on both sides of the split as the plain version's."""
    q, k, v, _, lens = _grid_inputs(cuda, seed=1)
    before = fa.partial_launches
    numer, m, l = fa.flash_attention_partial_cuda(q, k, v, lens, 0)
    torch.cuda.synchronize()
    assert fa.partial_launches == before + 2
    sl = GRID_ROWS
    r_numer, r_m, r_l = fa.flash_attention_partial_reference(q[sl], k[sl], v[sl], lens[sl], 0)
    rows = (lens[sl] > 0)[:, None, None].expand_as(r_m)
    assert bool(((m[sl] - r_m).abs() <= 1e-5 * r_m.abs() + 1e-6)[rows].all())
    assert bool(((l[sl] - r_l).abs() <= 1e-4 * r_l)[rows].all())
    live = torch.arange(GRID_SEQ, device=cuda)[None, :] < lens[sl][:, None]
    assert _bf16_row_ratio(numer[sl], r_numer, live & (lens[sl] > 0)[:, None]) <= 1.0


def test_rescore_past_the_grid_limit(cuda):
    """The rescore at 65,600 queries: two launches, the queries on both
    sides of the split as the plain version's (rtol 1e-5, -1e30 where
    missing)."""
    cand, sp_ids, sp_w, q_ids, q_w = (
        torch.from_numpy(x).to(cuda) for x in _rescore_inputs(65_600, 16, 5000, 32, 8, seed=5)
    )
    before = rs.launches
    got = rs.exact_rescore_cuda(cand, sp_ids, sp_w, q_ids, q_w)
    torch.cuda.synchronize()
    assert rs.launches == before + 2
    for sl in (slice(0, 64), slice(65_535 - 64, 65_600)):
        expected = rs.exact_rescore_oneshot(cand[sl], sp_ids, sp_w, q_ids[sl], q_w[sl])
        torch.testing.assert_close(got[sl], expected, rtol=1e-5, atol=1e-6)
        assert torch.equal(got[sl] <= -1e29, cand[sl] < 0)
