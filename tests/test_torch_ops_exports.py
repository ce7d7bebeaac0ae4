"""The host fusion, dense top-k and hybrid candidate entries the port's `ops`
exports, against the JAX package's.

The same numpy inputs (or the same hit dicts) go through the JAX function and
its port.

Tolerances:
- `rrf_merge_host`, `sanitize_hybrid_weights`: equal (pure Python, the same
  source); refusals raise the same `ValueError` message;
- `dense_topk`: rows equal; scores bit-equal on int8 rows (exact int32
  dots), within rtol 1e-5 on float32 and bf16 rows (float32 sums in another
  order); masked rows never returned;
- `hybrid_candidates`: rows equal for "xla" with ``exact_topk=True``; its
  "bucket" arm equal to JAX's bucket kernel in interpret mode (reached, as in
  the port, through `candidate_topk`).
"""

from __future__ import annotations

import inspect
import logging

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from verbatim_rag_tpu import ops as jax_ops
from verbatim_rag_tpu.ops import dense as jax_dense
from verbatim_rag_tpu.ops import fusion as jax_fusion
from verbatim_rag_tpu_torch import ops
from verbatim_rag_tpu_torch.ops import dense, fusion, hybrid

t = torch.from_numpy


def _hits(rng, ids, extra: str):
    return [{"id": i, "text": f"{extra}{i}", "score": float(rng.random())} for i in ids]


def _results(seed: int):
    rng = np.random.default_rng(seed)
    pool = [0, "", "a", "b", 7, 8, 9, "c", None]
    out = {}
    for method in ("dense", "sparse", "full_text"):
        ids = [pool[i] for i in rng.permutation(len(pool))[: int(rng.integers(3, len(pool)))]]
        out[method] = _hits(rng, ids, method)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize(
    "weights,top_k,rrf_k",
    [
        ({"dense": 1.0, "sparse": 1.0, "full_text": 1.0}, 5, 60),
        ({"dense": 0.7, "sparse": 0.3}, 3, 10),
        ({"dense": 0.0, "sparse": 0.0}, 10, 60),  # all zero: equal weights
    ],
)
def test_rrf_merge_host_matches_jax(seed, weights, top_k, rrf_k, caplog):
    results = _results(seed)
    with caplog.at_level(logging.INFO):
        got = fusion.rrf_merge_host(results, top_k, weights, rrf_k=rrf_k, log_label="t")
        want = jax_fusion.rrf_merge_host(results, top_k, weights, rrf_k=rrf_k, log_label="t")
    assert got == want
    assert len(got) == min(top_k, len({h["id"] for r in results.values() for h in r} - {None}))
    assert all(h["id"] is not None for h in got)


@pytest.mark.parametrize(
    "weights",
    [
        {"dense": 2, "sparse": 0.5},
        {"dense": 1.0, "bogus": 3.0, "full_text": 0.25},
        {"dense": -1.0, "sparse": "1", "full_text": 1.0},
        {},
        {"bogus": 1.0},
        {"dense": 0.0, "sparse": -2.0},
        {"dense": "heavy"},
    ],
)
def test_sanitize_hybrid_weights_matches_jax(weights):
    def outcome(fn):
        try:
            return fn(dict(weights))
        except ValueError as err:
            return ("ValueError", str(err))

    assert outcome(fusion.sanitize_hybrid_weights) == outcome(jax_fusion.sanitize_hybrid_weights)
    assert fusion.ALLOWED_METHODS == jax_fusion.ALLOWED_METHODS


@pytest.mark.parametrize("name", ["sanitize_hybrid_weights", "rrf_merge_host", "normalize_weights"])
def test_host_fusion_source_equals_the_original(name):
    assert inspect.getsource(getattr(fusion, name)) == inspect.getsource(getattr(jax_fusion, name))


def _corpus(n: int, d: int, b: int, seed: int):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = rng.random(n) > 0.2
    return corpus, q, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k", [1, 10])
def test_dense_topk_matches_jax(dtype, masked, k):
    corpus, q, mask = _corpus(600, 48, 5, seed=k + 3 * masked)
    mask_j, mask_t = (jnp.asarray(mask), t(mask)) if masked else (None, None)
    if dtype == "int8":
        codes, scale = jax_dense.quantize_rows_int8(corpus)
        e_scores, e_rows = jax_dense.dense_topk(
            jnp.asarray(codes), jnp.asarray(q), k, mask_j, corpus_scale=jnp.asarray(scale)
        )
        rows, extra = t(codes), dict(corpus_scale=t(scale))
    else:
        stored = corpus.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else corpus
        e_scores, e_rows = jax_dense.dense_topk(jnp.asarray(stored), jnp.asarray(q), k, mask_j)
        rows, extra = t(stored.astype(np.float32)).to(getattr(torch, dtype)), {}
    g_scores, g_rows = dense.dense_topk(rows, t(q), k, mask_t, **extra)
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    if dtype == "int8":
        np.testing.assert_array_equal(g_scores.numpy().view(np.int32), np.asarray(e_scores).view(np.int32))
    else:
        np.testing.assert_allclose(g_scores.numpy(), np.asarray(e_scores), rtol=1e-5, atol=1e-6)
    if masked:
        assert mask[g_rows.numpy()].all()
    # exact_topk=False selects exactly in the port (it has no approx_max_k).
    a_scores, a_rows = dense.dense_topk(rows, t(q), k, mask_t, exact_topk=False, **extra)
    assert torch.equal(a_rows, g_rows) and torch.equal(a_scores, g_scores)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("fetch_k,depth", [(4, 16), (10, 10)])
def test_hybrid_candidates_matches_jax(masked, fetch_k, depth):
    dense_c, dense_q, mask = _corpus(512, 32, 4, seed=fetch_k + depth)
    sketch_c, sketch_q, _ = _corpus(512, 64, 4, seed=fetch_k * depth)
    mask_j, mask_t = (jnp.asarray(mask), t(mask)) if masked else (None, None)
    d_codes, d_scale = jax_dense.quantize_rows_int8(dense_c)
    e_d, e_s = jax_ops.hybrid_candidates(
        jnp.asarray(d_codes), jnp.asarray(sketch_c), jnp.asarray(dense_q), jnp.asarray(sketch_q),
        fetch_k, depth, mask_j, exact_topk=True, dense_scale=jnp.asarray(d_scale),
    )
    g_d, g_s = ops.hybrid_candidates(
        t(d_codes), t(sketch_c), t(dense_q), t(sketch_q), fetch_k, depth, mask_t,
        exact_topk=True, dense_scale=t(d_scale),
    )
    np.testing.assert_array_equal(g_d.numpy(), np.asarray(e_d))
    np.testing.assert_array_equal(g_s.numpy(), np.asarray(e_s))
    assert g_d.shape == (4, fetch_k) and g_s.shape == (4, depth)


def test_hybrid_candidates_mark_missing_candidates_minus_one():
    corpus, q, _ = _corpus(64, 16, 2, seed=1)
    mask = np.zeros(64, bool)
    mask[:3] = True
    e_d, e_s = jax_ops.hybrid_candidates(
        jnp.asarray(corpus), jnp.asarray(corpus), jnp.asarray(q), jnp.asarray(q), 5, 6,
        jnp.asarray(mask),
    )
    g_d, g_s = ops.hybrid_candidates(t(corpus), t(corpus), t(q), t(q), 5, 6, t(mask))
    np.testing.assert_array_equal(g_d.numpy(), np.asarray(e_d))
    np.testing.assert_array_equal(g_s.numpy(), np.asarray(e_s))
    assert (g_d[:, 3:] == -1).all() and (g_s[:, 3:] == -1).all()


def test_hybrid_candidates_bucket_arm_reaches_the_bucket_table(monkeypatch):
    """``candidate_impl="bucket"`` without exact selection serves both arms
    from the bucket-max v2 table (its plain version on CPU tensors), equal
    to JAX's bucket kernel in interpret mode."""
    from verbatim_rag_tpu_torch.ops import fused_topk

    corpus, q, mask = _corpus(1024, 32, 3, seed=5)
    codes, scale = jax_dense.quantize_rows_int8(corpus)
    calls = []
    real = fused_topk.fused_candidate_topk_v2
    monkeypatch.setattr(fused_topk, "fused_candidate_topk_v2", lambda *a, **k: calls.append(1) or real(*a, **k))
    g_d, g_s = hybrid.hybrid_candidates(
        t(codes), t(codes), t(q), t(q), 8, 8, t(mask), exact_topk=False, dense_scale=t(scale),
        sketch_scale=t(scale), candidate_impl="bucket",
    )
    assert len(calls) == 2
    e_top, e_rows = jax_dense.candidate_topk(
        jnp.asarray(codes), jnp.asarray(q), 8, jnp.asarray(mask), jnp.asarray(scale),
        exact_topk=False, impl="bucket", interpret=True,
    )
    expected = np.where(np.asarray(e_top) > jax_dense.NEG_INF / 2, np.asarray(e_rows), -1)
    np.testing.assert_array_equal(g_d.numpy(), expected)
    np.testing.assert_array_equal(g_s.numpy(), expected)
    with pytest.raises(ValueError, match="candidate_impl"):
        hybrid.hybrid_candidates(t(codes), t(codes), t(q), t(q), 8, 8, candidate_impl="section")
