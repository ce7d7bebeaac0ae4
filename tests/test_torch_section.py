"""Section tables in the PyTorch port vs the JAX package's section kernel.

The same numpy inputs go through the JAX `section_bucket_tables` (the Pallas
kernel in interpret mode, as `tests/test_section_kernel.py` runs it) and the
port's plain version at small block sizes (128 and 256 columns).

Tolerances:
- int8 arms: tables bit-equal (compared as int32 views) — the int32 dots are
  exact and every float operation is the same on both sides;
- bf16 and float32 arms: float32 dots summed in another order, so packed
  values within 2⁻¹⁵ relative (the 7 packed bits are 2⁻¹⁶ of a value) and
  decoded rows equal except in buckets whose two best scores lie within
  that;
- `table_topk`, `hybrid_section_topk`: rows equal, values and RRF scores
  bit-equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.ops import section as jax_section
from verbatim_rag_tpu.ops.dense import quantize_rows_int8 as jax_quantize
from verbatim_rag_tpu_torch.ops import section

LANE = 128


def _arms(rng, n, dims, negative=False):
    corpora, queries = [], []
    for d in dims:
        c = rng.normal(size=(n, d)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        q = rng.normal(size=(13, d)).astype(np.float32)  # ragged batch
        if negative:  # every score below zero
            c, q = np.abs(c), -np.abs(q)
        corpora.append(c)
        queries.append(q)
    return corpora, queries


def _mask(n, block_cols):
    mask = np.ones(n, bool)
    mask[7] = False
    mask[block_cols + 3 :: LANE] = False  # lane 3 of the second block is dead
    mask[n - 40 :] = False
    return mask


def _jax_tables(corpora_t, queries, mask, scales, block_cols):
    return jax_section.section_bucket_tables(
        tuple(jnp.asarray(c) for c in corpora_t),
        tuple(jnp.asarray(q) for q in queries),
        None if mask is None else jnp.asarray(mask),
        scales=tuple(jnp.asarray(s) for s in scales),
        block_cols=block_cols, dot_chunk=128, q_block=8, interpret=True,
    )


def _port_tables(corpora, queries, mask, scales, block_cols, dtype=None):
    return section.section_bucket_tables(
        tuple(torch.from_numpy(c) if dtype is None else torch.from_numpy(c).to(dtype) for c in corpora),
        tuple(torch.from_numpy(q) for q in queries),
        None if mask is None else torch.from_numpy(mask),
        scales=tuple(torch.from_numpy(s) for s in scales),
        block_cols=block_cols,
    )


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("block_cols", [128, 256])
def test_int8_tables_bit_equal(block_cols, masked, negative):
    rng = np.random.default_rng(block_cols + 2 * masked + negative)
    n = 4 * block_cols
    corpora, queries = _arms(rng, n, (64, 32), negative)
    codes, scales = zip(*(jax_quantize(c) for c in corpora))
    mask = _mask(n, block_cols) if masked else None
    expected = _jax_tables([c.T.copy() for c in codes], queries, mask, scales, block_cols)
    got = _port_tables(codes, queries, mask, scales, block_cols)
    for g, e in zip(got, expected):
        assert g.shape == e.shape == (13, (n // block_cols) * LANE)
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.array(e).view(np.int32))
    if negative:
        assert (got[0][got[0] > -1e29] < 0).all()


def _decoded_rows(table, block_cols):
    vals, pos = section.unpack_table(table)
    cols = torch.arange(table.shape[1])
    return vals, (cols // LANE) * block_cols + pos * LANE + cols % LANE


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("block_cols", [128, 256])
def test_float_tables_match(block_cols, dtype):
    rng = np.random.default_rng(block_cols)
    n = 4 * block_cols
    corpora, queries = _arms(rng, n, (64, 32))
    mask = _mask(n, block_cols)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    expected = jax_section.section_bucket_tables(
        tuple(jnp.asarray(c.T.copy()).astype(jdt) for c in corpora),
        tuple(jnp.asarray(q) for q in queries),
        jnp.asarray(mask),
        block_cols=block_cols, dot_chunk=128, q_block=8, interpret=True,
    )
    got = _port_tables(corpora, queries, mask, (), block_cols, dtype=tdt)
    for arm, (g, e) in enumerate(zip(got, expected)):
        e = torch.from_numpy(np.array(e))
        g_vals, g_rows = _decoded_rows(g, block_cols)
        e_vals, e_rows = _decoded_rows(e, block_cols)
        live = e_vals > -1e29
        assert torch.equal(live, g_vals > -1e29)
        # 2⁻¹⁵ of the dot's own scale |q|·|c| (corpus rows have unit norm).
        q = torch.from_numpy(queries[arm]).to(tdt).float()
        tol = 2.0**-15 * q.norm(dim=1, keepdim=True).expand_as(g_vals)
        assert bool(((g_vals - e_vals).abs() <= tol)[live].all())
        # Rows may differ only in buckets whose two best scores are within tol.
        c = torch.from_numpy(corpora[arm]).to(tdt).float()
        scores = torch.where(torch.from_numpy(mask), q @ c.T, -1e30)
        blocks = scores.reshape(13, -1, block_cols // LANE, LANE)
        if blocks.shape[2] > 1:
            top2 = blocks.topk(2, dim=2).values
            near = (top2[:, :, 0] - top2[:, :, 1]).reshape(13, -1).abs() <= tol
        else:
            near = torch.zeros_like(live)
        assert bool(((g_rows == e_rows) | ~live | near).all())
        assert float((g_rows == e_rows)[live].float().mean()) > 0.95


def test_table_topk_matches_jax_with_ties():
    """Equal to `lax.top_k` (JAX's exact select) at every k, and to the
    store's "approx" select below the full table width. At k equal to the
    width, JAX's `approx_max_k` on the CPU orders ties highest column first;
    the port keeps `lax.top_k`'s lowest-first order."""
    rng = np.random.default_rng(5)
    n, block_cols = 512, 128
    corpora, queries = _arms(rng, n, (32,))
    corpora[0][10] = corpora[0][2]  # equal rows in one position: packed values tie
    corpora[0][300] = corpora[0][44]
    codes, scales = jax_quantize(corpora[0])
    mask = _mask(n, block_cols)
    (table,) = _jax_tables([codes.T.copy()], queries, mask, [scales], block_cols)
    table = np.array(table)
    width = table.shape[1]
    for k in (1, 10, 200, width - 1, width, width + 88):
        g_vals, g_rows = section.table_topk(torch.from_numpy(table), k, block_cols, n)
        impls = ("exact", "approx") if k < width else ("exact",)
        for impl in impls:
            e_vals, e_rows = jax_section.table_topk(
                jnp.asarray(table), k, block_cols, n, select_impl=impl
            )
            np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
            np.testing.assert_array_equal(g_vals.numpy(), np.asarray(e_vals))


def test_geometry_validation():
    q = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="multiple"):
        section.section_bucket_tables((torch.zeros(300, 16),), (q,), None, block_cols=256)
    with pytest.raises(ValueError, match="pos pack"):
        section.section_bucket_tables((torch.zeros(32768, 16),), (q,), None, block_cols=32768)
    with pytest.raises(ValueError, match="scale"):
        section.section_bucket_tables((torch.zeros(256, 16, dtype=torch.int8),), (q,), None, block_cols=256)


@pytest.mark.parametrize(
    "arms,expected",
    [
        # the int8 store with a float32 sketch: one launch a kind, arm order kept
        (
            [(torch.int8, 384), (torch.float32, 3072)],
            [(torch.int8, [0], [(128, 8)]), (torch.float32, [1], [(128, 0)])],
        ),
        # bf16 dense + int8 sketch
        (
            [(torch.bfloat16, 768), (torch.int8, 768)],
            [(torch.bfloat16, [0], [(128, 7)]), (torch.int8, [1], [(128, 7)])],
        ),
        # three arms, two kinds: the bf16 arms share a launch and mix tile sizes
        (
            [(torch.bfloat16, 768), (torch.int8, 2944), (torch.bfloat16, 1536)],
            [(torch.bfloat16, [0, 2], [(128, 7), (64, 7)]), (torch.int8, [1], [(64, 2)])],
        ),
        # one kind: one launch
        (
            [(torch.int8, 384), (torch.int8, 768), (torch.int8, 1168)],
            [(torch.int8, [0, 1, 2], [(128, 8), (128, 7), (64, 8)])],
        ),
        # rows past 2944 bytes stream their query tile (128 queries, 6
        # stages) in a launch of their own layout
        (
            [(torch.int8, 3072), (torch.int8, 768), (torch.bfloat16, 3072), (torch.int8, 4096)],
            [
                (torch.int8, [0, 3], [(128, 6), (128, 6)]), (torch.int8, [1], [(128, 7)]),
                (torch.bfloat16, [2], [(128, 6)]),
            ],
        ),
    ],
)
def test_plan_section_launches(arms, expected):
    """`section_tables_cuda` launches once per row kind (and layout of the
    query tile) on the same stream,
    each int8 / bf16 arm with the wgmma walk's tile and ring for section's
    side slots (`walk_geometry(row_bytes, "section")`), float32 arms on the
    FMA walk's 128-query tile (its ring depth is the kernel's own: 0); the
    call counts as one launch."""
    assert section.plan_section_launches(arms) == expected


def _hybrid_inputs(rng, n, d, dp, b, m, qm, vocab):
    dense = rng.normal(size=(n, d)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    sketch = rng.normal(size=(n, dp)).astype(np.float32)
    sp_ids = np.stack([rng.choice(np.arange(1, vocab), m, replace=False) for _ in range(n)])
    sp_w = (rng.random((n, m)) + 0.1).astype(np.float32)
    dq = rng.normal(size=(b, d)).astype(np.float32)
    dq /= np.linalg.norm(dq, axis=1, keepdims=True)
    sq = rng.normal(size=(b, dp)).astype(np.float32)
    q_ids = np.stack([rng.choice(np.arange(1, vocab), qm, replace=False) for _ in range(b)])
    q_w = (rng.random((b, qm)) + 0.1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[100:110] = False
    return dense, sketch, sp_ids.astype(np.int32), sp_w, dq, sq, q_ids.astype(np.int32), q_w, mask


@pytest.mark.parametrize("block_cols,depth", [(128, 64), (256, 64), (256, 1000)])
def test_hybrid_section_topk_matches_jax(block_cols, depth):
    rng = np.random.default_rng(block_cols + depth)
    n = 2 * block_cols
    dense, sketch, sp_ids, sp_w, dq, sq, q_ids, q_w, mask = _hybrid_inputs(
        rng, n, 16, 32, 5, 8, 6, 64
    )
    dense_i8, dense_s = jax_quantize(dense)
    sketch_i8, sketch_s = jax_quantize(sketch)
    kw = dict(k=10, fetch_k=20, depth=depth, dense_weight=0.6, sparse_weight=0.4, rrf_k=60)
    e_scores, e_rows = jax_section.hybrid_section_topk(
        jnp.asarray(dense_i8.T.copy()), jnp.asarray(sketch_i8.T.copy()),
        jnp.asarray(sp_ids), jnp.asarray(sp_w), jnp.asarray(dq), jnp.asarray(sq),
        jnp.asarray(q_ids), jnp.asarray(q_w), mask=jnp.asarray(mask),
        dense_scale=jnp.asarray(dense_s), sketch_scale=jnp.asarray(sketch_s),
        rescore_impl="oneshot", block_cols=block_cols, dot_chunk=128, q_block=8,
        interpret=True, **kw,
    )
    t = torch.from_numpy
    g_scores, g_rows = section.hybrid_section_topk(
        t(dense_i8), t(sketch_i8), t(sp_ids), t(sp_w), t(dq), t(sq), t(q_ids), t(q_w),
        mask=t(mask), dense_scale=t(dense_s), sketch_scale=t(sketch_s),
        rescore_impl="pallas", block_cols=block_cols, **kw,
    )
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    np.testing.assert_array_equal(g_scores.numpy(), np.asarray(e_scores))
    assert (g_rows >= 0).sum() > 0
