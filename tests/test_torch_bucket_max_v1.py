"""Consecutive-bucket max (v1) in the PyTorch port vs the JAX package's kernel.

The same numpy inputs go through the JAX `matmul_bucket_max` /
`fused_candidate_topk` (the Pallas kernel in interpret mode) and the port's
plain version (the CPU path of `matmul_bucket_max`).

Tolerances:
- exact-tie inputs (small-integer entries, so every dot is exact in float32
  and in bf16, and duplicate rows inside a bucket): values bit-equal, rows
  equal — the highest lane among equal values on both sides;
- other inputs: float32 dots summed in another order (bf16 products are
  exact in float32, so the same holds for bf16 rows). Values within
  2⁻¹⁵·|q| for bf16 rows, as the v2 checks, and 2⁻¹⁸·|q| for float32 rows
  (rows have unit norm; a sum of d products in float32 is off by about
  √d·2⁻²⁴·|q|, 1.7e-6·|q| at d = 768). Rows equal except in buckets whose two
  best plain scores lie within that limit;
- masked rows score exactly -1e30 on both sides, so dead buckets are equal;
- the geometry errors are the same `ValueError`s, word for word.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.ops import fused_topk as jax_ft
from verbatim_rag_tpu_torch.ops import fused_topk as ft

BUCKET = 128
LIMITS = {"bfloat16": 2.0**-15, "float32": 2.0**-18}
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _inputs(n, d, b, seed, dead_bucket=5):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.normal(size=(b, d)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::7] = False
    mask[dead_bucket * BUCKET : (dead_bucket + 1) * BUCKET] = False  # a fully dead bucket
    return corpus, q, mask


def _tie_inputs(n, d, b, seed):
    """Small-integer rows and queries (every dot exact) with duplicate rows
    inside buckets, some dead rows and one dead bucket."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    for g in range(0, n // BUCKET, 2):  # every other bucket: copies of one row
        base = g * BUCKET
        lanes = rng.choice(BUCKET, size=6, replace=False)
        corpus[base + lanes] = corpus[base + lanes[0]]
    corpus[BUCKET : 2 * BUCKET] = corpus[BUCKET]  # a bucket of one row
    mask = np.ones(n, bool)
    mask[3::11] = False
    mask[2 * BUCKET : 3 * BUCKET] = False
    return corpus, q, mask


def _jax(fn, corpus, q, mask, dtype, *args):
    out = fn(
        jnp.asarray(corpus).astype(DTYPES[dtype][0]), jnp.asarray(q), *args, jnp.asarray(mask),
        interpret=True,
    )
    return tuple(torch.from_numpy(np.array(x)) for x in out)


def _port(fn, corpus, q, mask, dtype, *args):
    return fn(
        torch.from_numpy(corpus).to(DTYPES[dtype][1]), torch.from_numpy(q), *args,
        torch.from_numpy(mask),
    )


def _assert_close(got, expected, corpus, q, mask, dtype):
    """Values within the dtype's limit of |q|; rows equal except in buckets
    whose two best plain scores are that close."""
    (g_vals, g_rows), (e_vals, e_rows) = got, expected
    live = e_vals > -1e29
    assert torch.equal(live, g_vals > -1e29)
    assert bool((g_vals[~live] == -1e30).all() and (e_vals[~live] == -1e30).all())
    qc = torch.from_numpy(q).to(DTYPES[dtype][1]).float()
    tol = LIMITS[dtype] * qc.norm(dim=1, keepdim=True).expand_as(g_vals)
    assert bool(((g_vals - e_vals).abs() <= tol)[live].all())
    c = torch.from_numpy(corpus).to(DTYPES[dtype][1]).float()
    scores = torch.where(torch.from_numpy(mask), qc @ c.T, -1e30)
    top2 = scores.reshape(q.shape[0], -1, BUCKET).topk(2, dim=2).values
    near = (top2[..., 0] - top2[..., 1]).abs() <= tol
    assert bool(((g_rows == e_rows) | near).all())
    assert torch.equal(g_rows[~live], e_rows[~live])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize(
    "n,d,b", [(2048, 64, 5), (16384, 32, 13), (2 * 16384, 16, 3)], ids=["n2048", "n16384", "n32768"]
)
def test_matches_jax(n, d, b, dtype):
    corpus, q, mask = _inputs(n, d, b, seed=n + b)
    expected = _jax(jax_ft.matmul_bucket_max, corpus, q, mask, dtype)
    before = ft.launches_v1
    got = _port(ft.matmul_bucket_max, corpus, q, mask, dtype)
    assert ft.launches_v1 == before  # CPU tensors never reach the kernel
    assert got[0].shape == got[1].shape == (b, n // BUCKET)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_close(got, expected, corpus, q, mask, dtype)
    # The dead bucket: -1e30 at its highest lane.
    assert (got[0][:, 5] == -1e30).all() and (got[1][:, 5] == 5 * BUCKET + 127).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,b", [(2048, 7), (2 * 16384, 9)])
def test_exact_ties_bit_equal(n, b, dtype):
    corpus, q, mask = _tie_inputs(n, 32, b, seed=n + b)
    e_vals, e_rows = _jax(jax_ft.matmul_bucket_max, corpus, q, mask, dtype)
    g_vals, g_rows = _port(ft.matmul_bucket_max, corpus, q, mask, dtype)
    np.testing.assert_array_equal(g_vals.numpy().view(np.int32), e_vals.numpy().view(np.int32))
    np.testing.assert_array_equal(g_rows.numpy(), e_rows.numpy())
    # Ties resolved to the highest lane: the all-copies bucket 1 reports lane 127.
    assert (g_rows[:, 1] == BUCKET + 127).all()
    assert (g_rows[:, 2] == 2 * BUCKET + 127).all() and (g_vals[:, 2] == -1e30).all()
    # A planted fault, ties to the lowest lane, would differ.
    scores = torch.where(torch.from_numpy(mask), torch.from_numpy(q) @ torch.from_numpy(corpus).T, -1e30)
    grouped = scores.reshape(b, -1, BUCKET)
    lowest = (grouped >= g_vals[..., None]).int().argmax(dim=2).int()  # first maximal lane
    lowest = lowest + torch.arange(0, n, BUCKET, dtype=torch.int32)[None, :]
    assert not torch.equal(lowest, g_rows)


@pytest.mark.parametrize("k", [1, 8, 16, 40])
def test_fused_candidate_topk_matches_jax(k):
    n, b = 2048, 4
    corpus, q, mask = _tie_inputs(n, 16, b, seed=k)
    mask[: 12 * BUCKET] = False  # 4 of 16 buckets live: rows −1 past them
    e_vals, e_rows = _jax(jax_ft.fused_candidate_topk, corpus, q, mask, "float32", k)
    g_vals, g_rows = _port(ft.fused_candidate_topk, corpus, q, mask, "float32", k)
    assert g_rows.shape == (b, min(k, n // BUCKET))
    np.testing.assert_array_equal(g_rows.numpy(), e_rows.numpy())
    np.testing.assert_array_equal(g_vals.numpy(), e_vals.numpy())
    assert ((g_rows == -1) == (g_vals <= -5e29)).all()
    assert int((g_rows >= 0).sum(dim=1).max()) <= 4


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_candidate_topk_float_rows(dtype):
    corpus, q, mask = _inputs(4096, 48, 6, seed=2)
    e_vals, e_rows = _jax(jax_ft.fused_candidate_topk, corpus, q, mask, dtype, 20)
    g_vals, g_rows = _port(ft.fused_candidate_topk, corpus, q, mask, dtype, 20)
    assert torch.equal(g_rows == -1, e_rows == -1)
    qc = torch.from_numpy(q).to(DTYPES[dtype][1]).float()
    tol = LIMITS[dtype] * qc.norm(dim=1, keepdim=True)
    assert bool(((g_vals - e_vals).abs() <= tol).all())
    # No two selected maxima of these inputs lie within the limit, so the
    # selections are equal.
    assert bool(((e_vals[:, :-1] - e_vals[:, 1:]) > tol).all())
    np.testing.assert_array_equal(g_rows.numpy(), e_rows.numpy())


@pytest.mark.parametrize("n", [960, 16384 + 128, 3 * 16384 + 2048])
def test_geometry_errors_match_jax(n):
    corpus, q, mask = np.zeros((n, 16), np.float32), np.zeros((2, 16), np.float32), np.ones(n, bool)
    with pytest.raises(ValueError) as expected:
        _jax(jax_ft.matmul_bucket_max, corpus, q, mask, "float32")
    with pytest.raises(ValueError) as got:
        _port(ft.matmul_bucket_max, corpus, q, mask, "float32")
    assert str(got.value) == str(expected.value)


def test_int8_corpus_refused():
    codes = torch.zeros(2048, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="no\\s+scale in v1"):
        ft.matmul_bucket_max(codes, torch.zeros(2, 16), torch.ones(2048, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        ft.matmul_bucket_max_cuda(
            torch.zeros(2048, 16), torch.zeros(2, 16), torch.ones(2048, dtype=torch.bool)
        )


@pytest.mark.parametrize(
    "n,batch,dtype,row_bytes,n_sm,expected",
    [
        (999_424, 512, torch.bfloat16, 768, 132, 8192),  # d=384: 4 query tiles × 122 blocks
        (999_424, 512, torch.bfloat16, 1536, 132, 16384),  # d=768: 8 query tiles × 61 blocks
        (16384, 512, torch.bfloat16, 768, 132, 1024),
        (16384, 512, torch.float32, 1536, 132, 1024),
        (384, 5, torch.float32, 256, 132, 384),  # blocks of ≤ 1024 rows stay whole
        (3 * 16384, 64, torch.bfloat16, 768, 132, 1024),  # 48 blocks: the 1024-row floor
        (2 * 16384, 512, torch.float32, 1536, 4, 16384),
    ],
)
def test_v1_block_rows(n, batch, dtype, row_bytes, n_sm, expected):
    """The largest block that leaves the grid two waves of one CTA an SM:
    at the bucket_ab shapes both widths come to 488 CTAs (3.7 waves)."""
    block = ft.v1_block_rows(n, batch, dtype, n_sm, row_bytes)
    assert block == expected and n % block == 0 and block % BUCKET == 0
