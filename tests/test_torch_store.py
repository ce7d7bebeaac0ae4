"""Device store in the PyTorch port vs the JAX package.

Both stores take the same records (hashed providers over a small corpus that
holds exact duplicates, so dense, sparse and RRF scores all tie) and answer
the same batched queries with exact selection (``approx_topk=False``; the
port always selects exactly, lowest index first among ties like
``lax.top_k``). Hybrid results must be equal: same rows in the same order,
bit-equal RRF scores. Dense and sparse scores are float32 dots summed in
another order: same rows, scores at rtol 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from verbatim_rag_tpu.engine.embedding_providers import (
    HashedBowDenseProvider,
    HashedSparseProvider,
)
from verbatim_rag_tpu.engine.store import DeviceVectorStore as JaxStore
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

TEXTS = [
    "solar panels convert sunlight into electricity",
    "wind turbines convert wind into electricity",
    "solar panels convert sunlight into electricity",  # exact duplicate
    "battery storage smooths solar output at night",
    "offshore wind farms see steadier wind",
    "hydro power stores energy in reservoirs",
    "solar panels",
    "wind wind wind turbines",
    "grid operators balance supply and demand",
    "battery storage smooths solar output at night",  # exact duplicate
    "geothermal plants tap heat from the earth",
    "panels and turbines both feed the grid",
]
QUERIES = [
    "solar panels electricity",
    "wind turbines",
    "battery storage at night",
    "nothing matches this query zzz",
    "grid supply",
]

DENSE = HashedBowDenseProvider(dim=64)
SPARSE = HashedSparseProvider(vocab_size=4096)


def _records(texts, start=0):
    dense = DENSE.embed_batch(texts)
    sparse = SPARSE.embed_batch(texts)
    return [
        {
            "id": f"r{start + i}",
            "text": t,
            "metadata": {"document_id": f"d{(start + i) % 3}"},
            "dense": dense[i],
            "sparse": sparse[i],
        }
        for i, t in enumerate(texts)
    ]


def _stores(block=16, flushes=(5, 4, 3), **options):
    kwargs = dict(
        dense_dim=64, sparse_vocab=4096, sparse_max_nnz=8, projection_dim=32,
        block=block, approx_topk=False, **options,
    )
    jax_store, port_store = JaxStore(**kwargs), DeviceVectorStore(device="cpu", **kwargs)
    start = 0
    for n in flushes:
        for store in (jax_store, port_store):
            store.add_vectors(_records(TEXTS[start : start + n], start))
            store.flush()
        start += n
    assert port_store._capacity == jax_store._capacity
    return jax_store, port_store


def _query(store, search_type, **kwargs):
    dense = DENSE.embed_batch(QUERIES) if search_type in ("hybrid", "dense") else None
    sparse = SPARSE.embed_batch(QUERIES) if search_type in ("hybrid", "sparse") else None
    return store.query_batch(
        dense_queries=dense, sparse_queries=sparse,
        search_type=None if search_type == "hybrid" else search_type, **kwargs,
    )


def _assert_same(got, expected, exact_scores):
    assert [[h.id for h in row] for row in got] == [[h.id for h in row] for row in expected]
    for g_row, e_row in zip(got, expected):
        g = np.array([h.score for h in g_row], np.float32)
        e = np.array([h.score for h in e_row], np.float32)
        if exact_scores:
            np.testing.assert_array_equal(g, e)
        else:
            np.testing.assert_allclose(g, e, rtol=1e-6, atol=1e-7)
        for gh, eh in zip(g_row, e_row):
            assert (gh.text, gh.metadata) == (eh.text, eh.metadata)


@pytest.mark.parametrize("top_k", [1, 3, 5, 20])
@pytest.mark.parametrize("search_type", ["hybrid", "dense", "sparse"])
def test_query_batch_matches_jax(search_type, top_k):
    jax_store, port_store = _stores()
    expected = _query(jax_store, search_type, top_k=top_k)
    got = _query(port_store, search_type, top_k=top_k)
    assert any(got)
    _assert_same(got, expected, exact_scores=search_type == "hybrid")


@pytest.mark.parametrize("search_type", ["hybrid", "dense", "sparse"])
def test_filters_and_deletes_match_jax(search_type):
    jax_store, port_store = _stores()
    for store in (jax_store, port_store):
        store.delete(["r0", "r7"])
    for flt in (None, {"document_id": "d1"}):
        expected = _query(jax_store, search_type, top_k=4, filter=flt)
        got = _query(port_store, search_type, top_k=4, filter=flt)
        _assert_same(got, expected, exact_scores=search_type == "hybrid")
        assert all(h.id not in ("r0", "r7") for row in got for h in row)
    assert port_store.count() == jax_store.count() == len(TEXTS) - 2


def test_hybrid_weights_and_depth_match_jax():
    jax_store, port_store = _stores(block=8192, flushes=(12,))
    kwargs = dict(
        top_k=4, hybrid_weights={"dense": 0.3, "sparse": 0.7}, rrf_k=10,
        search_params={"rescore_depth": 64},
    )
    _assert_same(
        _query(port_store, "hybrid", **kwargs), _query(jax_store, "hybrid", **kwargs), True
    )


def test_sparse_query_arrays_match_dicts():
    _, port_store = _stores()
    q_ids, q_w = port_store._pad_sparse_queries(SPARSE.embed_batch(QUERIES))
    dense = DENSE.embed_batch(QUERIES)
    from_arrays = port_store.query_batch(dense_queries=dense, sparse_queries=(q_ids, q_w), top_k=3)
    from_dicts = _query(port_store, "hybrid", top_k=3)
    assert [[h.id for h in r] for r in from_arrays] == [[h.id for h in r] for r in from_dicts]


def test_browsing_and_empty_store():
    _, port_store = _stores()
    assert port_store.get("r3").text == TEXTS[3]
    assert port_store.get("missing") is None
    assert [r.id for r in port_store.get_by_filter({"document_id": "d2"}, limit=2)] == ["r2", "r5"]
    assert port_store.size == len(TEXTS)
    empty = DeviceVectorStore(dense_dim=64, sparse_vocab=4096, device="cpu")
    assert empty.query_batch(dense_queries=DENSE.embed_batch(QUERIES[:2])) == [[], []]


@pytest.mark.parametrize(
    "kwargs,mesh_size",
    [
        (dict(candidate_impl="section", dense_dtype="int4"), None),
        (dict(candidate_impl="section", dense_dtype="int8", sketch_dtype="int4"), None),
        (dict(dense_dim=7, dense_dtype="int4"), None),
        (dict(enable_full_text=True, projection_dim=9, sketch_dtype="int4"), None),
        (dict(block=100), 8),  # rows would not shard evenly
        (dict(block=6, sparse_mode="exact"), 4),
        (dict(block=8192, candidate_impl="section", enable_full_text=True), 2),
        (dict(block=8 * 8192, candidate_impl="section", sketch_dtype="int4"), 8),
    ],
)
def test_options_of_later_slices_raise(kwargs, mesh_size):
    """The int4 tier and a mesh, which earlier slices refused, raise only
    where the JAX store raises, with its ``ValueError`` and message."""
    from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from verbatim_rag_tpu_torch.parallel import make_mesh

    jax_kwargs, port_kwargs = dict(kwargs), dict(kwargs, device="cpu")
    if mesh_size:
        import jax

        jax_kwargs["mesh"] = jax_make_mesh(dp=mesh_size, devices=jax.devices()[:mesh_size])
        port_kwargs["mesh"] = make_mesh(dp=mesh_size, devices=["cpu"] * mesh_size)
    with pytest.raises(ValueError) as want:
        JaxStore(**jax_kwargs)
    with pytest.raises(ValueError) as got:
        DeviceVectorStore(**port_kwargs)
    assert str(got.value) == str(want.value)


NARROW_INDEX = [
    dict(sparse_ids_dtype="int16"),
    dict(sparse_weight_dtype="float16"),
    dict(sparse_ids_dtype="int16", sparse_weight_dtype="float16"),
]


@pytest.mark.parametrize("options", NARROW_INDEX, ids=["int16", "float16", "int16_float16"])
@pytest.mark.parametrize("search_type", ["hybrid", "sparse"])
def test_narrow_forward_index_matches_jax(search_type, options):
    """int16 ids and float16 weights: the same rows, and scores at the
    tolerances above (the rescore widens the float16 weights on both sides,
    after rounding them to nearest even in the same way)."""
    jax_store, port_store = _stores(**options)
    assert port_store._sp_ids.dtype == (
        torch.int16 if "sparse_ids_dtype" in options else torch.int32
    )
    assert port_store._sp_w.dtype == (
        torch.float16 if "sparse_weight_dtype" in options else torch.float32
    )
    np.testing.assert_array_equal(port_store._sp_ids.numpy(), np.asarray(jax_store._sp_ids))
    np.testing.assert_array_equal(
        port_store._sp_w.numpy().view(np.uint8), np.asarray(jax_store._sp_w).view(np.uint8)
    )
    for top_k in (3, 20):
        expected = _query(jax_store, search_type, top_k=top_k)
        got = _query(port_store, search_type, top_k=top_k)
        assert any(got)
        _assert_same(got, expected, exact_scores=search_type == "hybrid")


def test_narrow_ids_need_a_small_vocab():
    for store_cls in (JaxStore, lambda **kw: DeviceVectorStore(device="cpu", **kw)):
        with pytest.raises(ValueError, match="32768"):
            store_cls(sparse_vocab=40000, sparse_ids_dtype="int16")
    store = DeviceVectorStore(device="cpu", sparse_vocab=32768, sparse_ids_dtype="int16")
    assert store.sparse_ids_dtype == "int16"


@pytest.mark.parametrize(
    "spec",
    ["xla,xla", "xla,bucket", "bucket,xla", "bucket,bucket", "xla,section", "xla,bucket,xla"],
)
def test_comma_pair_candidate_impl_matches_jax(spec, caplog):
    """The retired 0.4.x comma-pair specs: a valid pair of "xla"/"bucket"
    maps to "xla" with the JAX store's warning; other comma specs raise its
    ValueError word for word."""

    def build(store_cls):
        caplog.clear()
        try:
            store = store_cls(candidate_impl=spec)
        except ValueError as err:
            return str(err), None, [r.getMessage() for r in caplog.records]
        return (
            store.candidate_impl, store.candidate_impl_requested,
            [r.getMessage() for r in caplog.records if r.levelname == "WARNING"],
        )

    with caplog.at_level("WARNING"):
        expected = build(JaxStore)
        got = build(lambda **kw: DeviceVectorStore(device="cpu", **kw))
    assert got == expected
    if spec.count(",") == 1 and "section" not in spec:
        assert got[:2] == ("xla", "xla") and "0.4.x" in got[2][0]
    else:
        assert "is not a valid spec" in got[0]


def test_persistence_raises(tmp_path):
    """Persistence is ported (`tests/test_torch_persistence.py`, onto a mesh
    `tests/test_torch_mesh_store.py`); what still raises: a missing file. An
    empty store compacts nothing and saves and loads as empty."""
    store = DeviceVectorStore(device="cpu")
    assert store.compact() == 0
    store.save(str(tmp_path / "empty"))
    assert DeviceVectorStore.load(str(tmp_path / "empty"), device="cpu").count() == 0
    with pytest.raises(FileNotFoundError):
        DeviceVectorStore.load(str(tmp_path / "x"), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert DeviceVectorStore().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceVectorStore()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 4, 17])
def test_topk_matches_lax_top_k_with_ties(seed, k):
    import jax

    from verbatim_rag_tpu_torch.ops.dense import topk

    rng = np.random.default_rng(seed)
    scores = rng.integers(-3, 4, size=(5, 40)).astype(np.float32)  # many ties
    scores[1, 10:] = -1e30  # a masked tail ties at the boundary
    scores[2] = 0.5  # the whole row ties
    expected_vals, expected_pos = jax.lax.top_k(scores, k)
    vals, pos = topk(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(expected_pos))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(expected_vals))
