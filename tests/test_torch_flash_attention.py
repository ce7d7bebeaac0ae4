"""Flash attention in the PyTorch port vs the JAX package.

The port's plain version (`attention_reference`) is held against the JAX
reference and against the JAX Pallas kernel run in interpret mode, on the
same numpy inputs: windowed, ragged, zero-length and non-dividing sequence
lengths. float32 throughout; tolerance atol/rtol 1e-5 (float32 sums taken in
another order). Query rows at or past their row's length are compared only
against the reference: the kernel writes 0 where every key is masked, the
reference the uniform average, and pad rows are discarded downstream.

The CUDA kernel itself is compared with the plain version on the card in
`tests/test_torch_cuda_kernels.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from verbatim_rag_tpu.ops.flash_attention import (
    attention_reference as jax_reference,
    flash_attention_tpu,
)
from verbatim_rag_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [
    # (batch, seq, heads, head_dim, lengths, window)
    (2, 64, 2, 16, [64, 40], None),
    (2, 64, 2, 16, [64, 40], 16),
    (3, 100, 2, 8, [100, 0, 37], None),  # zero-length row, S not a block multiple
    (3, 100, 2, 8, [100, 0, 37], 32),
    (1, 130, 1, 32, [130], 128),  # ModernBERT's window width
    (2, 96, 3, 16, [1, 96], 8),
]


def _inputs(batch, seq, heads, head_dim, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(batch, seq, heads, head_dim)).astype(np.float32) for _ in range(3))
    return q, k, v, np.asarray(lengths, np.int32)


def _live(lengths, seq):
    return np.arange(seq)[None, :] < np.asarray(lengths)[:, None]  # [B, S]


@pytest.mark.parametrize("batch,seq,heads,head_dim,lengths,window", CASES)
def test_plain_matches_jax_reference(batch, seq, heads, head_dim, lengths, window):
    q, k, v, lens = _inputs(batch, seq, heads, head_dim, lengths)
    expected = np.asarray(jax_reference(*map(jnp.asarray, (q, k, v, lens)), window))
    got = fa.attention_reference(*map(torch.from_numpy, (q, k, v, lens)), window).numpy()
    assert got.dtype == np.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, **TOL)


@pytest.mark.parametrize("batch,seq,heads,head_dim,lengths,window", CASES)
def test_plain_matches_interpreted_tpu_kernel(batch, seq, heads, head_dim, lengths, window):
    q, k, v, lens = _inputs(batch, seq, heads, head_dim, lengths, seed=1)
    expected = np.asarray(
        flash_attention_tpu(
            *map(jnp.asarray, (q, k, v, lens)), window=window, q_block=32, k_block=32,
            interpret=True,
        )
    )
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v, lens)), window).numpy()
    live = _live(lens, seq)
    np.testing.assert_allclose(got[live], expected[live], **TOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, lens = map(torch.from_numpy, _inputs(2, 48, 2, 16, [48, 5]))
    before = fa.launches
    out = fa.flash_attention(q, k, v, lens, 16)
    assert fa.launches == before
    torch.testing.assert_close(out, fa.attention_reference(q, k, v, lens, 16), rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, lens = map(torch.from_numpy, _inputs(1, 16, 1, 16, [16]))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v, lens)
