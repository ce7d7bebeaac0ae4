"""Exact sparse rescore in the PyTorch port vs the JAX package.

The port's plain versions (`exact_rescore_oneshot`, the "scan"
`exact_rescore_device`) are held against the JAX one-shot reduction, the JAX
scan and the JAX Pallas kernel in interpret mode, on the same numpy inputs.
Tolerance rtol 1e-5: float32 sums over the m slots are taken in another
order. Missing candidates (row −1) must give exactly −1e30 on both sides.

The CUDA kernel (row gather fused in) is compared with the plain version on
the card in `tests/test_torch_cuda_kernels.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from verbatim_rag_tpu.ops.hybrid import exact_rescore_device as jax_scan
from verbatim_rag_tpu.ops.rescore import (
    exact_rescore_device_pallas as jax_pallas,
    exact_rescore_oneshot as jax_oneshot,
)
from verbatim_rag_tpu_torch.ops import rescore as rs
from verbatim_rag_tpu_torch.ops.hybrid import exact_rescore_device, rescore_fn

NEG_INF = -1e30


def _setup(b=4, c=8, n=64, m=16, qm=8, seed=0):
    """Forward index with unique term ids per row (pads id 0 / weight 0),
    queries overlapping its vocab, and some missing candidates."""
    rng = np.random.default_rng(seed)
    vocab = np.arange(1, max(200, 2 * max(m, qm)))
    sp_ids = np.zeros((n, m), np.int32)
    sp_w = np.zeros((n, m), np.float32)
    for r in range(n):
        nnz = rng.integers(0, m + 1)
        sp_ids[r, :nnz] = rng.choice(vocab, size=nnz, replace=False)
        sp_w[r, :nnz] = rng.gamma(2.0, 1.0, size=nnz).astype(np.float32)
    q_ids = np.zeros((b, qm), np.int32)
    q_w = np.zeros((b, qm), np.float32)
    for r in range(b):
        nnz = rng.integers(1, qm + 1)
        q_ids[r, :nnz] = rng.choice(vocab, size=nnz, replace=False)
        q_w[r, :nnz] = rng.gamma(2.0, 1.0, size=nnz).astype(np.float32)
    cand = rng.integers(0, n, size=(b, c)).astype(np.int32)
    cand[0, -2:] = -1
    cand[-1, 0] = -1
    return cand, sp_ids, sp_w, q_ids, q_w


SHAPES = [
    dict(b=4, c=8, n=64, m=16, qm=8),
    dict(b=5, c=16, n=128, m=8, qm=4, seed=3),
    dict(b=3, c=7, n=50, m=5, qm=3, seed=4),  # m, C not multiples of anything
    dict(b=2, c=33, n=300, m=40, qm=16, seed=5),
]

JAX_IMPLS = {
    "oneshot": lambda *a: jax_oneshot(*a),
    "scan": lambda *a: jax_scan(*a),
    "pallas_interpret": lambda *a: jax_pallas(*a, interpret=True),
}


def _setup_repeats(b=4, c=12, n=80, m=24, qm=10, seed=0):
    """`_setup`'s forward index and queries with what a hash table of the
    query's terms must still count: the same id several times in a row and
    in a query (each (slot, term) pair that matches adds its product), a
    query term of id 0 with a nonzero weight (matching every pad slot, whose
    weight 0 adds 0, and every live slot of id 0), and rows of both."""
    cand, sp_ids, sp_w, q_ids, q_w = _setup(b=b, c=c, n=n, m=m, qm=qm, seed=seed)
    rng = np.random.default_rng(seed + 100)
    sp_ids[::3, 1::4] = sp_ids[::3, :1]  # duplicate ids within rows
    sp_ids[1::5, 2] = 0  # a live slot of id 0
    sp_w[1::5, 2] = 0.5
    q_ids[:, 1::3] = q_ids[:, :1]  # duplicate ids within a query
    q_w[:, 1::3] = rng.gamma(2.0, 1.0, size=q_w[:, 1::3].shape).astype(np.float32)
    q_ids[:, -1] = 0  # id 0 with a nonzero weight
    q_w[:, -1] = 0.75
    cand[:, 1] = cand[:, 0]  # the same row twice among a query's candidates
    return cand, sp_ids, sp_w, q_ids, q_w


REPEAT_SHAPES = [
    dict(b=4, c=12, n=80, m=24, qm=10),
    dict(b=3, c=9, n=60, m=5, qm=7, seed=2),
    dict(b=2, c=20, n=200, m=130, qm=40, seed=6),
]


@pytest.mark.parametrize("jax_impl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("shape", REPEAT_SHAPES, ids=lambda s: "b{b}c{c}m{m}q{qm}".format(**s))
def test_repeated_ids_and_id_zero_match_jax(jax_impl, shape):
    """Duplicate ids in rows and queries and a query term of id 0: the port's
    plain versions (one-shot and scan) against each JAX implementation."""
    arrays = _setup_repeats(**shape)
    assert (arrays[3] == 0).any() and (arrays[3][:, 1] == arrays[3][:, 0]).all()
    expected = np.asarray(JAX_IMPLS[jax_impl](*map(jnp.asarray, arrays)))
    for fn in (rs.exact_rescore_oneshot, exact_rescore_device):
        got = fn(*map(torch.from_numpy, arrays)).numpy()
        _check(got, expected, arrays[0])


def _check(got, expected, cand):
    miss = cand < 0
    assert got.dtype == np.float32 and got.shape == expected.shape
    assert (got[miss] == NEG_INF).all() and (expected[miss] <= NEG_INF / 2).all()
    np.testing.assert_allclose(got[~miss], expected[~miss], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("jax_impl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{b}c{c}m{m}q{qm}".format(**s))
def test_plain_oneshot_matches_jax(jax_impl, shape):
    arrays = _setup(**shape)
    expected = np.asarray(JAX_IMPLS[jax_impl](*map(jnp.asarray, arrays)))
    got = rs.exact_rescore_oneshot(*map(torch.from_numpy, arrays)).numpy()
    _check(got, expected, arrays[0])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{b}c{c}m{m}q{qm}".format(**s))
def test_plain_scan_matches_jax_scan(shape):
    arrays = _setup(**shape)
    expected = np.asarray(jax_scan(*map(jnp.asarray, arrays)))
    got = exact_rescore_device(*map(torch.from_numpy, arrays)).numpy()
    _check(got, expected, arrays[0])


@pytest.mark.parametrize("impl", ["scan", "oneshot", "pallas"])
def test_rescore_impls_agree_on_cpu(impl):
    arrays = _setup(**SHAPES[0])
    before = rs.launches
    got = rescore_fn(impl)(*map(torch.from_numpy, arrays)).numpy()
    assert rs.launches == before  # CPU tensors never reach the kernel
    expected = rs.exact_rescore_oneshot(*map(torch.from_numpy, arrays)).numpy()
    _check(got, expected, arrays[0])


NARROW = {"int16": (np.int16, np.float32), "float16": (np.int32, np.float16),
          "int16_float16": (np.int16, np.float16)}


@pytest.mark.parametrize("jax_impl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("narrow", sorted(NARROW))
def test_narrow_forward_index_matches_jax(narrow, jax_impl):
    """int16 ids and float16 weights, as the store keeps them with
    ``sparse_ids_dtype="int16"`` / ``sparse_weight_dtype="float16"``: both
    sides widen the gathered slots, so the tolerance is the same."""
    id_type, w_type = NARROW[narrow]
    cand, sp_ids, sp_w, q_ids, q_w = _setup(**SHAPES[3])
    arrays = (cand, sp_ids.astype(id_type), sp_w.astype(w_type), q_ids, q_w)
    expected = np.asarray(JAX_IMPLS[jax_impl](*map(jnp.asarray, arrays)))
    for fn in (rs.exact_rescore_oneshot, exact_rescore_device):
        got = fn(*map(torch.from_numpy, arrays)).numpy()
        _check(got, expected, cand)


def test_kernel_wrapper_checks_inputs():
    arrays = [torch.from_numpy(a) for a in _setup(**SHAPES[0])]
    with pytest.raises(ValueError, match="CUDA"):
        rs.exact_rescore_cuda(*arrays)
