"""The int8 store tier in the PyTorch port vs the JAX package's store.

Both stores take the same records (hashed providers over a small corpus with
exact duplicates, see `test_torch_store.py`) with
``dense_dtype = sketch_dtype = "int8"``. Under ``candidate_impl="auto"`` both
resolve to the section path; the JAX store runs its section kernel in
interpret mode (``VERBATIM_SECTION_INTERPRET=1``, a test setting of the JAX
package), the port its plain version.

Tolerances:
- dense codes and scales: bit-equal (both quantize the same float32 rows);
  sketch codes within ±1 and scales at rtol 1e-5, because the two packages
  sum the projected sketches in another order;
- hybrid results: same rows in the same order, bit-equal RRF scores;
- single-method dense and sparse results: same rows, scores at rtol 1e-6.

The rescore depth is held below the bucket table's width (128 columns at
these capacities) where duplicates tie in the table: at the full width the
JAX store's ``approx_max_k`` orders those ties highest column first on the
CPU, the port lowest first (``approx_max_k`` promises no tie order).
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from test_torch_store import TEXTS, _assert_same, _query, _records
from verbatim_rag_tpu.engine.store import DeviceVectorStore as JaxStore
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

INT8 = dict(dense_dtype="int8", sketch_dtype="int8")


@pytest.fixture(autouse=True)
def _section_interpret(monkeypatch):
    monkeypatch.setenv("VERBATIM_SECTION_INTERPRET", "1")


def _stores(block=8192, flushes=(5, 4, 3), texts=TEXTS, **extra):
    kwargs = dict(
        dense_dim=64, sparse_vocab=4096, sparse_max_nnz=8, projection_dim=32, block=block,
        **INT8, **extra,
    )
    jax_store, port_store = JaxStore(**kwargs), DeviceVectorStore(device="cpu", **kwargs)
    start = 0
    for n in flushes:
        for store in (jax_store, port_store):
            store.add_vectors(_records(texts[start : start + n], start))
            store.flush()
        start += n
    assert port_store._capacity == jax_store._capacity
    assert port_store.candidate_impl == jax_store.candidate_impl
    return jax_store, port_store


def test_flush_quantizes_like_jax():
    jax_store, port_store = _stores(flushes=(12,))
    n = len(TEXTS)
    np.testing.assert_array_equal(port_store._dense[:n].numpy(), np.asarray(jax_store._dense[:n]))
    np.testing.assert_array_equal(
        port_store._dense_scale[:n].numpy().view(np.int32),
        np.array(jax_store._dense_scale[:n]).view(np.int32),
    )
    sketch = port_store._sp_proj[:n].numpy().astype(np.int32)
    assert np.abs(sketch - np.asarray(jax_store._sp_proj[:n], np.int32)).max() <= 1
    np.testing.assert_allclose(
        port_store._sp_proj_scale[:n].numpy(), np.asarray(jax_store._sp_proj_scale[:n]), rtol=1e-5
    )
    assert port_store._dense.dtype == port_store._sp_proj.dtype == torch.int8
    assert port_store._dense.shape == (8192, 64) and port_store._dense_scale.shape == (8192, 1)


@pytest.mark.parametrize(
    "kwargs,expected",
    [
        (INT8, "section"),
        (dict(INT8, approx_topk=False), "xla"),
        (dict(dense_dtype="int8"), "xla"),
        (dict(dense_dtype="int8", sketch_dtype="bfloat16"), "xla"),
        ({}, "xla"),
        (dict(INT8, candidate_impl="bucket"), "bucket"),
        (dict(candidate_impl="section"), "section"),
    ],
)
def test_candidate_impl_resolves_like_jax(kwargs, expected):
    port = DeviceVectorStore(device="cpu", **kwargs)
    assert port.candidate_impl == JaxStore(**kwargs).candidate_impl == expected
    assert port._per_stage_candidate_impl == ("xla" if expected == "section" else expected)


@pytest.mark.parametrize("block", [8192, 16384])
@pytest.mark.parametrize("top_k", [1, 4, 10])
def test_hybrid_section_matches_jax(block, top_k):
    jax_store, port_store = _stores(block=block)
    assert port_store.candidate_impl == "section"
    kwargs = dict(top_k=top_k, search_params={"rescore_depth": 64})
    expected = _query(jax_store, "hybrid", **kwargs)
    got = _query(port_store, "hybrid", **kwargs)
    assert any(got)
    _assert_same(got, expected, exact_scores=True)


def test_hybrid_section_full_table_width_without_ties():
    """At the default depth the sketch arm selects the whole bucket table;
    with no duplicate rows there is no tie to order."""
    texts = list(dict.fromkeys(TEXTS))
    jax_store, port_store = _stores(flushes=(len(texts),), texts=texts)
    for top_k in (3, 8):
        _assert_same(
            _query(port_store, "hybrid", top_k=top_k), _query(jax_store, "hybrid", top_k=top_k), True
        )


@pytest.mark.parametrize("block", [8192, 16384])
def test_section_filters_and_deletes_match_jax(block):
    jax_store, port_store = _stores(block=block)
    for store in (jax_store, port_store):
        store.delete(["r0", "r7"])
    for flt in (None, {"document_id": "d1"}):
        kwargs = dict(top_k=4, filter=flt, search_params={"rescore_depth": 64})
        got = _query(port_store, "hybrid", **kwargs)
        _assert_same(got, _query(jax_store, "hybrid", **kwargs), exact_scores=True)
        assert all(h.id not in ("r0", "r7") for row in got for h in row)


@pytest.mark.parametrize("how", ["store", "per_query"])
def test_exact_selection_matches_jax(how, monkeypatch):
    """approx_topk=False (on the store, or per query) takes the exact
    per-arm program on both sides."""
    from verbatim_rag_tpu_torch.ops import section

    extra = dict(approx_topk=False) if how == "store" else {}
    jax_store, port_store = _stores(**extra)
    kwargs = dict(top_k=5)
    if how == "per_query":
        kwargs["search_params"] = {"approx_topk": False}
    calls = []
    original = section.hybrid_section_topk
    monkeypatch.setattr(
        section, "hybrid_section_topk", lambda *a, **k: calls.append(1) or original(*a, **k)
    )
    got = _query(port_store, "hybrid", **kwargs)
    assert calls == []
    _assert_same(got, _query(jax_store, "hybrid", **kwargs), exact_scores=True)


@pytest.mark.parametrize("search_type", ["dense", "sparse"])
@pytest.mark.parametrize("top_k", [2, 6])
def test_single_method_queries_match_jax(search_type, top_k):
    jax_store, port_store = _stores()
    got = _query(port_store, search_type, top_k=top_k)
    assert any(got)
    _assert_same(got, _query(jax_store, search_type, top_k=top_k), exact_scores=False)


def test_section_geometry_fallback_warns_once(caplog):
    """A capacity that does not tile 8192-row blocks takes the per-arm
    program, with one warning, and agrees with the JAX store (on rows
    without duplicates: every selection here spans the whole capacity)."""
    texts = list(dict.fromkeys(TEXTS))
    jax_store, port_store = _stores(block=16, flushes=(len(texts),), texts=texts)
    with caplog.at_level(logging.WARNING, logger="verbatim_rag_tpu_torch.engine.store"):
        got = _query(port_store, "hybrid", top_k=3)
        _query(port_store, "hybrid", top_k=3)
    warned = [r for r in caplog.records if "cannot serve" in r.getMessage()]
    assert len(warned) == 1 and "8192" in warned[0].getMessage()
    _assert_same(got, _query(jax_store, "hybrid", top_k=3), exact_scores=True)


def test_bucket_store_matches_jax():
    """candidate_impl="bucket": the port runs the bucket table's plain
    version (the JAX store falls back to its XLA program off the TPU). Every
    row has a bucket of its own here, so the candidates agree."""
    jax_store, port_store = _stores(candidate_impl="bucket")
    for search_type in ("hybrid", "sparse"):
        got = _query(port_store, search_type, top_k=4, search_params={"rescore_depth": 64})
        expected = _query(jax_store, search_type, top_k=4, search_params={"rescore_depth": 64})
        _assert_same(got, expected, exact_scores=search_type == "hybrid")


def test_rag_query_on_int8_index():
    from verbatim_rag_tpu_torch.engine import (
        HashedBowDenseProvider,
        HashedSparseProvider,
        VerbatimIndex,
    )
    from verbatim_rag_tpu_torch.rag import VerbatimRAG

    index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(dim=64), sparse_provider=HashedSparseProvider(4096),
        device="cpu", **INT8,
    )
    index.add_documents(
        [{"content": "\n\n".join(TEXTS), "title": "Energy"}, {"content": TEXTS[4], "title": "Wind"}]
    )
    assert index.store.candidate_impl == "section"
    assert index.store._dense.dtype == torch.int8
    response = VerbatimRAG(index).query("How do solar panels make electricity?")
    assert response.documents
    for doc in response.documents:
        for h in doc.highlights:
            assert doc.content[h.start : h.end] == h.text
