"""The PyTorch port's mesh store vs the JAX package's (`tests/test_parallel.py`'s
``TestMeshStore``, ``TestMeshStoreLifecycle`` and mesh-section cases, each held
to the JAX mesh store on the same records).

The JAX store shards over its 8 virtual CPU devices (``make_mesh(dp=4,
tp=2)``), the port over ``make_mesh(dp=4, tp=2, devices=["cpu"] * 8)``; the
section path needs a block of ``mesh.size * 8192`` rows, so it runs on a
2-device mesh on both sides (the JAX kernel in interpret mode,
``VERBATIM_SECTION_INTERPRET=1``). Records come from a seed with numpy.

Tolerances: rows equal, scores at rtol / atol 5e-4.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.engine.store import DeviceVectorStore as JaxStore
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
from verbatim_rag_tpu_torch.parallel import Mesh, RowSharded, make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

RTOL = ATOL = 5e-4
COMMON = dict(
    dense_dim=16, sparse_vocab=64, sparse_max_nnz=8, block=64, projection_dim=32, rescore_depth=512
)


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(dp=4, tp=2), make_mesh(dp=4, tp=2, devices=["cpu"] * 8)


def _records(n=300, d=16, vocab=64, nnz=6, seed=11):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        vec = rng.normal(size=d).astype(np.float32)
        terms = rng.choice(np.arange(1, vocab), size=nnz, replace=False)
        records.append(
            {
                "id": f"r{i}",
                "text": f"document number {i} about topic {i % 7}",
                "enhanced_text": f"enhanced {i}",
                "metadata": {"document_id": f"doc{i % 10}", "topic": i % 7},
                "dense": vec,
                "sparse": {int(t): float(rng.random() + 0.05) for t in terms},
            }
        )
    return records


def _stores(meshes, records=None, **kwargs):
    """(JAX mesh store, port mesh store, port single-device store), filled."""
    jax_mesh, mesh = meshes
    records = _records() if records is None else records
    options = {**COMMON, **kwargs}
    stores = (
        JaxStore(mesh=jax_mesh, **options),
        DeviceVectorStore(mesh=mesh, **options),
        DeviceVectorStore(device="cpu", **options),
    )
    for store in stores:
        store.add_vectors([dict(r) for r in records])
        store.flush()
    return stores


def _assert_same(got, want):
    assert [[h.id for h in r] for r in got] == [[h.id for h in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h.score for h in g], [h.score for h in w], rtol=RTOL, atol=ATOL)


def _all_agree(stores, **query):
    jax_store, port_mesh, port_single = stores
    got = port_mesh.query_batch(**query)
    _assert_same(got, jax_store.query_batch(**query))
    _assert_same(got, port_single.query_batch(**query))
    return got


def _q(seed, b=3):
    return np.random.default_rng(seed).normal(size=(b, 16)).astype(np.float32)


QS = [{3: 1.0, 9: 0.5}, {40: 2.0, 5: 0.1}, {1: 1.0, 2: 1.0, 4: 1.0}]


def test_arrays_are_row_sharded(meshes):
    _, port_mesh, port_single = _stores(meshes)
    assert port_mesh.device == torch.device("cpu") and port_mesh._capacity == 320
    for name in ("_dense", "_sp_ids", "_sp_w", "_sp_proj", "_valid_dev"):
        arr = getattr(port_mesh, name)
        assert isinstance(arr, RowSharded) and len(arr.shards) == 8 and arr.rows_per_shard == 40
        torch.testing.assert_close(arr[:320], getattr(port_single, name), rtol=0, atol=0)


def test_dense_parity(meshes):
    _all_agree(_stores(meshes), dense_queries=_q(3, 4), top_k=10)


def test_sparse_projected_parity(meshes):
    _all_agree(_stores(meshes), sparse_queries=QS[:2], top_k=8)


def test_sparse_exact_mode_parity(meshes):
    _all_agree(_stores(meshes, sparse_mode="exact"), sparse_queries=QS[:1], top_k=8)


def test_hybrid_parity(meshes):
    _all_agree(_stores(meshes), dense_queries=_q(5), sparse_queries=QS, top_k=6)


@pytest.mark.parametrize("rescore_impl", ["pallas", "oneshot", "scan"])
def test_hybrid_parity_kernel_impls(meshes, rescore_impl):
    """The per-shard rescore and candidate knobs keep mesh-vs-JAX parity
    (the JAX side's bucket request falls back to "xla" off the TPU; the
    port's shards of 40 rows are below the bucket kernel's geometry)."""
    stores = _stores(meshes, rescore_impl=rescore_impl, candidate_impl="bucket")
    _all_agree(stores, dense_queries=_q(5), sparse_queries=QS, top_k=6)
    _all_agree(stores, sparse_queries=QS, top_k=8)


@pytest.mark.parametrize(
    "tier",
    [
        dict(dense_dtype="int8"),
        dict(sketch_dtype="int8"),
        dict(dense_dtype="int8", sketch_dtype="int8"),
        dict(dense_dtype="int4", sketch_dtype="int4"),
        dict(dense_dtype="int4", sketch_dtype="int8"),
    ],
    ids=["int8_dense", "int8_sketch", "int8", "int4", "int4_int8"],
)
@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
def test_quantized_tiers_parity(meshes, tier, search_type):
    stores = _stores(meshes, **tier)
    assert stores[1].candidate_impl == stores[0].candidate_impl == "xla"  # "auto" on a mesh
    q = _q(11)
    query = {
        "dense": dict(dense_queries=q, top_k=10),
        "sparse": dict(sparse_queries=QS, top_k=8),
        "hybrid": dict(dense_queries=q, sparse_queries=QS, top_k=6),
    }[search_type]
    _all_agree(stores, **query)
    if tier.get("dense_dtype") == "int4":
        np.testing.assert_array_equal(stores[1]._dense[:320].numpy(), np.asarray(stores[0]._dense))


def test_filter_and_delete_parity(meshes):
    stores = _stores(meshes)
    for store in stores:
        store.delete([f"r{i}" for i in range(0, 50)])
    got = _all_agree(stores, dense_queries=_q(9, 2), top_k=10, filter={"topic": 3})
    for hits in got:
        assert hits and all(h.metadata["topic"] == 3 and int(h.id[1:]) >= 50 for h in hits)


def test_filter_matching_one_row_returns_only_it(meshes):
    """A filter that leaves shards with fewer live rows than the depth: no
    phantom rows from the missing (−1) candidates."""
    jax_mesh, mesh = meshes
    recs = []
    for i in range(32):
        v = np.zeros(8, np.float32)
        v[i % 8] = 1.0
        recs.append({"id": f"c{i}", "text": f"t{i}", "metadata": {"document_id": f"d{i}"},
                     "dense": v, "sparse": {i % 64: 1.0, (i + 3) % 64: 0.5}})
    for store in (
        JaxStore(dense_dim=8, sparse_vocab=64, sparse_max_nnz=4, block=16, mesh=jax_mesh),
        DeviceVectorStore(dense_dim=8, sparse_vocab=64, sparse_max_nnz=4, block=16, mesh=mesh),
    ):
        store.add_vectors([dict(r) for r in recs])
        hits = store.query(sparse_query={30: 1.0}, filter={"document_id": "d30"}, top_k=5)
        assert [h.id for h in hits] == ["c30"]
        hits = store.query(
            dense_query=np.eye(8, dtype=np.float32)[30 % 8], sparse_query={30: 1.0},
            filter={"document_id": "d30"}, top_k=5,
        )
        assert [h.id for h in hits] == ["c30"]


def test_hybrid_array_queries_parity(meshes):
    """(ids, weights) query arrays and tensor dense queries (the encoder
    handoff) through the mesh store."""
    from verbatim_rag_tpu_torch.engine.store import _pad_sparse

    stores = _stores(meshes)
    q = _q(5)
    ids = np.zeros((3, 4), np.int32)
    w = np.zeros((3, 4), np.float32)
    for i, row in enumerate(QS):
        ids[i], w[i] = _pad_sparse(row, 4)
    got = stores[1].query_batch(
        dense_queries=torch.from_numpy(q), sparse_queries=(torch.from_numpy(ids), torch.from_numpy(w)),
        top_k=6,
    )
    _assert_same(got, stores[0].query_batch(dense_queries=q, sparse_queries=QS, top_k=6))


def _text_store(mesh, store_cls, n=64, **kwargs):
    options = dict(
        dense_dim=16, sparse_vocab=64, sparse_max_nnz=8, block=64, projection_dim=32,
        rescore_depth=512, enable_full_text=True, full_text_vocab=256, full_text_max_nnz=16,
    )
    store = store_cls(mesh=mesh, **{**options, **kwargs})
    rng = np.random.default_rng(11)
    store.add_vectors(
        [
            {
                "id": f"d{i}",
                "text": "solar " * (i % 7 + 1) + f"grid unique{i} " + "turbine " * (i // 7 + 1),
                "dense": rng.normal(size=16).astype(np.float32),
                "sparse": {int(i % 60) + 1: 1.0 + 0.01 * i},
            }
            for i in range(n)
        ]
    )
    store.flush()
    return store


def _tie_groups(hits):
    groups = {}
    for h in hits:
        groups.setdefault(round(h.score, 6), set()).add(h.id)
    return groups


def test_3way_fused_hybrid_parity(meshes):
    """dense + sparse + full text rides the sharded 3-way program (the BM25
    arm as ``ft_arm``). RRF ties members of one arm at equal rank, so ids
    are compared per tie group and scores exactly."""
    jax_mesh, mesh = meshes
    jax_store = _text_store(jax_mesh, JaxStore)
    port_store = _text_store(mesh, DeviceVectorStore)
    query = dict(
        dense_queries=_q(12, 2), sparse_queries=QS[:2], text_queries=["solar grid", "turbine unique3"],
        hybrid_weights={"dense": 0.4, "sparse": 0.3, "full_text": 0.3}, top_k=6,
    )
    for got, want in zip(port_store.query_batch(**query), jax_store.query_batch(**query)):
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=1e-5, atol=1e-7)
        assert _tie_groups(got) == _tie_groups(want)


def test_full_text_parity(meshes):
    jax_mesh, mesh = meshes

    def build(mesh_arg, store_cls):
        store = store_cls(
            dense_dim=None, sparse_vocab=None, enable_full_text=True, full_text_vocab=256,
            full_text_max_nnz=16, block=64, projection_dim=32, rescore_depth=512, mesh=mesh_arg,
        )
        store.add_vectors(
            [{"id": f"d{i}", "text": "solar " * (i % 9 + 1) + f"panel grid w{i} " + "storage " * (i // 9 + 1)}
             for i in range(80)]
        )
        return store

    jax_store, port_store = build(jax_mesh, JaxStore), build(mesh, DeviceVectorStore)
    for query in ("solar storage", "panel w3"):
        got = port_store.query_batch(text_queries=[query], top_k=6)[0]
        want = jax_store.query_batch(text_queries=[query], top_k=6)[0]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=RTOL, atol=ATOL)
        assert [h.id for h in got] == [h.id for h in want]


def test_index_query_parity(meshes):
    """`VerbatimIndex(mesh=...)` end to end against the JAX index on its mesh
    (tie-free corpus: each document carries the query terms with its own
    multiplicity)."""
    from verbatim_rag_tpu.engine.embedding_providers import (
        HashedBowDenseProvider as JaxDense,
        HashedSparseProvider as JaxSparse,
    )
    from verbatim_rag_tpu.engine.index import VerbatimIndex as JaxIndex
    from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex

    jax_mesh, mesh = meshes
    words = [f"w{j}" for j in range(400)]
    rng = np.random.default_rng(21)
    docs = [
        {"content": f"Paragraph {i}: " + "solar " * (i + 1) + "wind " * ((i * 7) % 40 + 1)
         + " ".join(rng.choice(words, size=12, replace=False)), "title": f"d{i}"}
        for i in range(40)
    ]
    jax_index = JaxIndex(dense_provider=JaxDense(dim=64), sparse_provider=JaxSparse(vocab_size=128), mesh=jax_mesh)
    port_index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(dim=64), sparse_provider=HashedSparseProvider(vocab_size=128),
        mesh=mesh,
    )
    assert port_index.device == torch.device("cpu") and port_index.store.mesh is mesh
    for index in (jax_index, port_index):
        index.store.block = 64
        index.add_documents([dict(d) for d in docs])
    for question in ("solar panel efficiency", "wind turbine storage"):
        got, want = port_index.query(question, k=5), jax_index.query(question, k=5)
        assert [h.text for h in got] == [h.text for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=RTOL, atol=ATOL)


# -- lifecycle --------------------------------------------------------------------------------


def test_delete_compact_query_parity(meshes):
    stores = _stores(meshes)
    dead = [f"r{i}" for i in range(0, 120, 2)]
    for store in stores:
        store.delete(dead)
        assert store.compact() == len(dead)
        assert len(store._ids) == 300 - len(dead)
    assert stores[1].mesh is meshes[1] and isinstance(stores[1]._dense, RowSharded)
    got = _all_agree(stores, dense_queries=_q(13), sparse_queries=QS, top_k=8)
    assert all(int(h.id[1:]) % 2 == 1 or int(h.id[1:]) >= 120 for r in got for h in r)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_compact_quantized_parity(meshes, tier):
    stores = _stores(meshes, dense_dtype=tier, sketch_dtype=tier)
    for store in stores:
        store.delete([f"r{i}" for i in range(50)])
        assert store.compact() == 50
    _all_agree(stores, dense_queries=_q(17, 2), top_k=8)
    _all_agree(stores, dense_queries=_q(17, 2), sparse_queries=QS[:2], top_k=8)


def test_reserve_on_mesh(meshes):
    jax_mesh, mesh = meshes
    stores = (
        JaxStore(mesh=jax_mesh, **COMMON), DeviceVectorStore(mesh=mesh, **COMMON),
        DeviceVectorStore(device="cpu", **COMMON),
    )
    for store in stores:
        store.reserve(512)
        assert store._capacity == 512
        store.add_vectors(_records())
        store.flush()
        assert store._capacity == 512  # no growth during the ingest
    assert stores[1]._dense.rows_per_shard == 64
    _all_agree(stores, dense_queries=_q(19, 2), top_k=10)


@pytest.mark.parametrize("tier", [{}, dict(dense_dtype="int4", sketch_dtype="int4")], ids=["bf16", "int4"])
def test_growth_across_flushes_re_places_rows(meshes, tier):
    """Each flush that doubles capacity moves every global row to the shard
    that now holds it; queries after every flush agree with JAX's."""
    jax_mesh, mesh = meshes
    records = _records()
    jax_store, port_store = JaxStore(mesh=jax_mesh, **COMMON, **tier), DeviceVectorStore(mesh=mesh, **COMMON, **tier)
    capacities = []
    for start, stop in ((0, 40), (40, 100), (100, 300)):
        for store in (jax_store, port_store):
            store.add_vectors([dict(r) for r in records[start:stop]])
            store.flush()
        capacities.append(port_store._capacity)
        assert port_store._capacity == jax_store._capacity
        assert port_store._dense.rows_per_shard == port_store._capacity // 8
        query = dict(dense_queries=_q(start), sparse_queries=QS, top_k=6)
        _assert_same(port_store.query_batch(**query), jax_store.query_batch(**query))
        np.testing.assert_array_equal(
            port_store._sp_ids[:stop].numpy(), np.asarray(jax_store._sp_ids[:stop])
        )
    assert capacities == [64, 128, 512]


def test_auto_compact_under_mesh(meshes):
    _, mesh = meshes
    store = DeviceVectorStore(mesh=mesh, **{**COMMON, "rescore_depth": 256}, auto_compact_threshold=0.3)
    store.add_vectors(_records(n=200))
    store.flush()
    store.delete([f"r{i}" for i in range(100)])
    assert len(store._ids) == 100 and isinstance(store._dense, RowSharded)
    hits = store.query_batch(dense_queries=_q(23, 1), top_k=5)[0]
    assert hits and all(int(h.id[1:]) >= 100 for h in hits)


@pytest.mark.parametrize(
    "modes", [{}, dict(dense_dtype="int8", sketch_dtype="int8"), dict(dense_dtype="int4", sketch_dtype="int4")],
    ids=["bf16", "int8", "int4"],
)
@pytest.mark.parametrize("saver", ["port_mesh", "jax_mesh", "port_single"])
def test_save_then_load_onto_mesh(meshes, tmp_path, modes, saver):
    """Persistence is placement-free: a store saved by either package, on a
    mesh or not, loads onto the port's mesh (re-sharded at load time) and
    onto one device, and all agree with the JAX store loaded on its mesh."""
    jax_mesh, mesh = meshes
    stores = dict(zip(("jax_mesh", "port_mesh", "port_single"), _stores(meshes, **modes)))
    for store in stores.values():
        store.delete(["r3", "r77"])
    path = str(tmp_path / "idx")
    stores[saver].save(path)
    back_mesh = DeviceVectorStore.load(path, mesh=mesh)
    back_single = DeviceVectorStore.load(path, device="cpu")
    back_jax = JaxStore.load(path, mesh=jax_mesh)
    assert back_mesh.mesh is mesh and back_single.mesh is None
    assert isinstance(back_mesh._dense, RowSharded) and back_mesh._dense.rows_per_shard == 40
    query = dict(dense_queries=_q(29, 2), sparse_queries=QS[:2], top_k=8)
    want = back_jax.query_batch(**query)
    _assert_same(back_mesh.query_batch(**query), want)
    _assert_same(back_single.query_batch(**query), want)
    _assert_same(stores["port_mesh"].query_batch(**query), want)


def test_index_load_onto_mesh(meshes, tmp_path):
    from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex

    _, mesh = meshes
    index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(dim=64), sparse_provider=HashedSparseProvider(vocab_size=128),
        device="cpu", sketch_dtype="int4",
    )
    index.add_documents([{"content": f"solar {i} wind {i % 3} storage", "title": f"t{i}"} for i in range(20)])
    index.save(str(tmp_path / "idx"))
    loaded = VerbatimIndex.load(str(tmp_path / "idx"), mesh=mesh)
    assert loaded.store.mesh is mesh and loaded.device == torch.device("cpu")
    got, want = loaded.query("solar wind", k=4), index.query("solar wind", k=4)
    assert [h.id for h in got] == [h.id for h in want]


# -- the constructor -------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(block=100),  # not a multiple of the mesh size
        dict(block=8192, candidate_impl="section"),  # not a multiple of mesh.size * 8192
        dict(block=8 * 8192, candidate_impl="section", dense_dtype="int4"),
    ],
)
def test_mesh_options_raise_like_jax(meshes, kwargs):
    jax_mesh, mesh = meshes
    with pytest.raises(ValueError) as want:
        JaxStore(mesh=jax_mesh, **kwargs)
    with pytest.raises(ValueError) as got:
        DeviceVectorStore(mesh=mesh, **kwargs)
    assert str(got.value) == str(want.value)


def test_mesh_device_rules():
    cpu_mesh = make_mesh(dp=2, devices=["cpu"] * 2)
    assert DeviceVectorStore(mesh=cpu_mesh, device="cpu").device == torch.device("cpu")
    cuda_mesh = Mesh([[torch.device("cuda", 0)], [torch.device("cuda", 0)]])
    with pytest.raises(ValueError, match="mesh"):
        DeviceVectorStore(mesh=cuda_mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(dp=2)


# -- the section path on a mesh ----------------------------------------------------------------


@pytest.fixture
def two_device_meshes(monkeypatch):
    monkeypatch.setenv("VERBATIM_SECTION_INTERPRET", "1")
    return jax_make_mesh(dp=2, devices=jax.devices()[:2]), make_mesh(dp=2, devices=["cpu"] * 2)


def _section_stores(meshes, n, **kwargs):
    jax_mesh, mesh = meshes
    options = dict(
        dense_dim=16, sparse_vocab=64, sparse_max_nnz=8, block=2 * 8192, projection_dim=32,
        rescore_depth=64, candidate_impl="section", **kwargs,
    )
    stores = (JaxStore(mesh=jax_mesh, **options), DeviceVectorStore(mesh=mesh, **options))
    for store in stores:
        store.add_vectors(_records(n=n))
        store.flush()
    return stores


@pytest.mark.parametrize("tier", [{}, dict(dense_dtype="int8", sketch_dtype="int8")], ids=["bf16", "int8"])
def test_mesh_store_section_parity(two_device_meshes, monkeypatch, tier):
    """Hybrid queries of a section mesh store take the per-shard section
    program once a batch, on both sides, and agree."""
    import verbatim_rag_tpu.parallel.sharded_search as jss
    import verbatim_rag_tpu_torch.parallel.sharded_search as ss

    jax_store, port_store = _section_stores(two_device_meshes, 200, **tier)
    assert port_store.candidate_impl == jax_store.candidate_impl == "section"
    calls = {"jax": 0, "port": 0}
    for module, side in ((jss, "jax"), (ss, "port")):
        real = module.sharded_hybrid_section_topk

        def spy(*a, _real=real, _side=side, **kw):
            calls[_side] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, "sharded_hybrid_section_topk", spy)
    query = dict(dense_queries=_q(7, 2), sparse_queries=QS[:2], top_k=6)
    _assert_same(port_store.query_batch(**query), jax_store.query_batch(**query))
    assert calls == {"jax": 1, "port": 1}


def test_mesh_store_section_3way_parity(two_device_meshes):
    jax_mesh, mesh = two_device_meshes
    kwargs = dict(block=2 * 8192, candidate_impl="section", rescore_depth=64)
    jax_store = _text_store(jax_mesh, JaxStore, **kwargs)
    port_store = _text_store(mesh, DeviceVectorStore, **kwargs)
    query = dict(
        dense_queries=_q(12, 2), sparse_queries=QS[:2], text_queries=["solar grid", "turbine unique3"],
        top_k=6,
    )
    for got, want in zip(port_store.query_batch(**query), jax_store.query_batch(**query)):
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=1e-5, atol=1e-7)
        assert _tie_groups(got) == _tie_groups(want)


def test_mesh_store_exact_request_falls_back(two_device_meshes, monkeypatch):
    """approx_topk=False on a section mesh store serves through the sharded
    "xla" program, and the section program is never entered."""
    import verbatim_rag_tpu_torch.parallel.sharded_search as ss

    jax_store, port_store = _section_stores(two_device_meshes, 64, approx_topk=False)

    def boom(*a, **kw):
        raise AssertionError("an exact request must not ride the bucket tables")

    monkeypatch.setattr(ss, "sharded_hybrid_section_topk", boom)
    query = dict(dense_queries=_q(3, 1), sparse_queries=QS[:1], top_k=4)
    got = port_store.query_batch(**query)
    assert got and got[0]
    _assert_same(got, jax_store.query_batch(**query))
