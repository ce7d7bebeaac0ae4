"""The int4 capacity tier in the PyTorch port vs the JAX package
(`tests/test_int4_mode.py`'s cases, each held to the JAX package).

Rows are quantized to 4-bit codes packed two a byte (`ops/dense.py::Int4Rows`,
the half-split layout). Inputs come from a seed with numpy; the same rows and
queries go through both packages.

Tolerances: packed bytes and scales bit-equal (both quantize the same
float32 rows); sketch codes within ±1 nibble and scales at rtol 1e-5, since
the two packages sum the projected sketches in another order; query results:
the same rows in the same order, scores at rtol / atol 5e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.engine.store import DeviceVectorStore as JaxStore
from verbatim_rag_tpu.ops import dense as jax_dense
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
from verbatim_rag_tpu_torch.ops import dense
from verbatim_rag_tpu_torch.ops.dense import Int4Rows, quantize_rows_int4, unpack_int4

RTOL = ATOL = 5e-4
DIM, VOCAB, NNZ, N = 16, 64, 4, 48


def _rows(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- the carrier ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 24), (5, 2), (64, 384), (3, 768)])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_pack_matches_jax(shape, kind):
    x = _rows(3, shape)
    x[0] = 0.0  # a zero row takes the 1e-12 scale floor
    want = jax_dense.quantize_rows_int4(x)
    got = quantize_rows_int4(x if kind == "numpy" else torch.from_numpy(x))
    assert isinstance(got, Int4Rows) and got.shape == shape
    packed, scale = (np.asarray(t) for t in got)
    assert packed.dtype == np.int8 and packed.shape == (shape[0], shape[1] // 2)
    np.testing.assert_array_equal(packed, np.asarray(want.packed))
    np.testing.assert_array_equal(scale.view(np.int32), np.asarray(want.scale).view(np.int32))


def test_unpack_matches_jax_on_every_byte():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    got = unpack_int4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dense.unpack_int4(jnp.asarray(packed))))
    assert got.dtype == np.int8 and got.shape == (4, 128)


def test_requantization_is_stable():
    """Dequantize → requantize reproduces the codes (the legacy load path
    of a file without ``dense_i4`` depends on it)."""
    q1 = quantize_rows_int4(torch.from_numpy(_rows(5, (8, 16))))
    deq = unpack_int4(q1.packed).float() * q1.scale
    q2 = quantize_rows_int4(deq)
    torch.testing.assert_close(q2.packed, q1.packed, rtol=0, atol=0)
    torch.testing.assert_close(q2.scale, q1.scale, rtol=1e-6, atol=0)


def test_odd_width_raises_like_jax():
    x = np.zeros((2, 7), np.float32)
    with pytest.raises(ValueError, match="even") as want:
        jax_dense.quantize_rows_int4(x)
    with pytest.raises(ValueError, match="even") as got:
        quantize_rows_int4(torch.from_numpy(x))
    assert str(got.value).split(",")[0] == str(want.value).split(",")[0]


@pytest.mark.parametrize("seed", range(3))
def test_dense_scores_match_jax(seed):
    """int8 queries × unpacked codes × scales, as the JAX package's compiled
    programs compute them."""
    corpus, q = _rows(seed, (96, 32)), _rows(seed + 10, (5, 32))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = np.asarray(jax.jit(jax_dense.dense_scores)(jax_dense.quantize_rows_int4(corpus), jnp.asarray(q)))
    rows = quantize_rows_int4(torch.from_numpy(corpus))
    got = dense.dense_scores(rows, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (np.argsort(-got, axis=1, kind="stable") == np.argsort(-want, axis=1, kind="stable")).all()


def test_int4_corpus_never_takes_the_bucket_kernel(monkeypatch):
    """Packed int4 bytes are int8: a bare packed tensor would pass the int8
    bucket kernel's check. The carrier keeps it off: "bucket" gives the
    "xla" result and the bucket path is never entered."""
    from verbatim_rag_tpu_torch.ops import fused_topk

    def boom(*args, **kwargs):
        raise AssertionError("an int4 corpus reached the bucket-max path")

    monkeypatch.setattr(fused_topk, "fused_candidate_topk_v2", boom)
    rows = quantize_rows_int4(torch.from_numpy(_rows(1, (4096, 32))))
    q = torch.from_numpy(_rows(2, (3, 32)))
    assert not dense.bucket_kernel_supported(rows, None, 16)
    want = dense.candidate_topk(rows, q, 16, impl="xla")
    got = dense.candidate_topk(rows, q, 16, impl="bucket")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- the store ------------------------------------------------------------------------------


def _records(n=N, seed=13):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        terms = rng.choice(np.arange(1, VOCAB), size=NNZ, replace=False)
        recs.append(
            {
                "id": f"r{i}",
                "text": f"text {i}",
                "metadata": {"document_id": f"d{i % 3}"},
                "dense": rng.normal(size=DIM).astype(np.float32),
                "sparse": {int(t): float(rng.random() + 0.05) for t in terms},
            }
        )
    return recs


def _common(**kwargs):
    return {
        **dict(
            dense_dim=DIM, sparse_vocab=VOCAB, sparse_max_nnz=NNZ, block=16, rescore_depth=32,
            projection_dim=32,
        ),
        **kwargs,
    }


def _both(**kwargs):
    jax_store = JaxStore(**_common(**kwargs))
    port_store = DeviceVectorStore(device="cpu", **_common(**kwargs))
    for store in (jax_store, port_store):
        store.add_vectors(_records())
        store.flush()
    assert port_store._capacity == jax_store._capacity
    return jax_store, port_store


def _queries(seed=17, b=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, DIM)).astype(np.float32)
    qs = [{int(t): float(rng.random() + 0.1) for t in rng.choice(np.arange(1, VOCAB), 6, replace=False)} for _ in range(b)]
    return q, qs


def _assert_same(got, want):
    assert [[h.id for h in r] for r in got] == [[h.id for h in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h.score for h in g], [h.score for h in w], rtol=RTOL, atol=ATOL)


def _ask(store, search_type, top_k, seed=17):
    q, qs = _queries(seed)
    if search_type == "dense":
        return store.query_batch(dense_queries=q, top_k=top_k)
    if search_type == "sparse":
        return store.query_batch(sparse_queries=qs, top_k=top_k)
    return store.query_batch(dense_queries=q, sparse_queries=qs, top_k=top_k)


TIERS = [
    dict(dense_dtype="int4"),
    dict(sketch_dtype="int4"),
    dict(dense_dtype="int4", sketch_dtype="int4"),
    dict(dense_dtype="int4", sketch_dtype="int8"),
]


@pytest.mark.parametrize("tier", TIERS, ids=["dense", "sketch", "both", "int4_int8"])
def test_flush_packs_like_jax(tier):
    jax_store, port_store = _both(**tier)
    if tier.get("dense_dtype") == "int4":
        assert port_store._dense.dtype == torch.int8 and port_store._dense.shape == (N, DIM // 2)
        np.testing.assert_array_equal(port_store._dense.numpy(), np.asarray(jax_store._dense))
        np.testing.assert_array_equal(
            port_store._dense_scale.numpy().view(np.int32), np.asarray(jax_store._dense_scale).view(np.int32)
        )
        np.testing.assert_allclose(
            port_store._dense_rows_f32(N), jax_store._dense_rows_f32(N), rtol=0, atol=0
        )
    if tier.get("sketch_dtype") == "int4":
        assert port_store._sp_proj.shape == (N, 16)
        got = unpack_int4(port_store._sp_proj).numpy().astype(np.int32)
        want = np.asarray(jax_dense.unpack_int4(jax_store._sp_proj), np.int32)
        assert np.abs(got - want).max() <= 1
        np.testing.assert_allclose(
            port_store._sp_proj_scale.numpy(), np.asarray(jax_store._sp_proj_scale), rtol=1e-5
        )


@pytest.mark.parametrize("top_k", [1, 5, 10])
@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("tier", TIERS, ids=["dense", "sketch", "both", "int4_int8"])
def test_query_rows_match_jax(tier, search_type, top_k):
    jax_store, port_store = _both(**tier)
    assert port_store.candidate_impl == jax_store.candidate_impl == "xla"
    _assert_same(_ask(port_store, search_type, top_k), _ask(jax_store, search_type, top_k))


def test_int4_sketches_exact_at_full_depth():
    """Depth covering the corpus: candidate selection loses nothing and the
    exact rescore fixes every score, so int4 sketches give the float
    sketches' sparse results (`test_int4_mode.py`'s strongest check)."""
    ref = DeviceVectorStore(device="cpu", **_common(rescore_depth=64))
    alt = DeviceVectorStore(device="cpu", **_common(rescore_depth=64, sketch_dtype="int4"))
    for s in (ref, alt):
        s.add_vectors(_records())
    rng = np.random.default_rng(31)
    qs = [{int(t): float(rng.random() + 0.1) for t in range(1, VOCAB)} for _ in range(2)]
    _assert_same(alt.query_batch(sparse_queries=qs, top_k=8), ref.query_batch(sparse_queries=qs, top_k=8))


def test_filtered_hybrid_matches_jax():
    jax_store, port_store = _both(dense_dtype="int4", sketch_dtype="int4")
    q, qs = _queries(23)
    for store in (jax_store, port_store):
        store.delete(["r1", "r4", "r7"])
    kwargs = dict(dense_queries=q, sparse_queries=qs, top_k=6, filter={"document_id": "d1"})
    _assert_same(port_store.query_batch(**kwargs), jax_store.query_batch(**kwargs))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_in_one_package_load_in_the_other(tmp_path, direction):
    jax_store, port_store = _both(dense_dtype="int4", sketch_dtype="int4")
    for store in (jax_store, port_store):
        store.delete(["r2", "r9"])
    path = str(tmp_path / "idx4")
    if direction == "jax_to_port":
        jax_store.save(path)
        loaded, same_side = DeviceVectorStore.load(path, device="cpu"), JaxStore.load(path)
    else:
        port_store.save(path)
        loaded, same_side = JaxStore.load(path), DeviceVectorStore.load(path, device="cpu")
    codes = np.load(path + ".npz")["dense_i4"]
    assert codes.shape == (N, DIM // 2)
    np.testing.assert_array_equal(np.asarray(loaded._dense[:N]), codes)
    np.testing.assert_array_equal(np.asarray(same_side._dense[:N]), codes)
    assert loaded.dense_dtype == loaded.sketch_dtype == "int4"
    for search_type in ("dense", "sparse", "hybrid"):
        _assert_same(_ask(loaded, search_type, 6), _ask(same_side, search_type, 6))
        _assert_same(_ask(loaded, search_type, 6), _ask(port_store, search_type, 6))


def test_save_load_roundtrip_is_bit_exact(tmp_path):
    _, store = _both(dense_dtype="int4", sketch_dtype="int4")
    before = _ask(store, "dense", 6)
    store.save(str(tmp_path / "idx"))
    loaded = DeviceVectorStore.load(str(tmp_path / "idx"), device="cpu")
    after = _ask(loaded, "dense", 6)
    assert [[h.id for h in r] for r in after] == [[h.id for h in r] for r in before]
    assert [[h.score for h in r] for r in after] == [[h.score for h in r] for r in before]


def test_delete_and_compact_match_jax():
    jax_store, port_store = _both(dense_dtype="int4", sketch_dtype="int4")
    dead = [f"r{i}" for i in range(0, N, 5)]
    for store in (jax_store, port_store):
        store.delete(dead)
        assert store.compact() == len(dead)
    np.testing.assert_array_equal(port_store._dense.numpy(), np.asarray(jax_store._dense))
    for search_type in ("dense", "hybrid"):
        got = _ask(port_store, search_type, 5)
        _assert_same(got, _ask(jax_store, search_type, 5))
        assert not any(h.id in dead for r in got for h in r)


def test_reserve_then_flush_keeps_packed_widths():
    store = DeviceVectorStore(device="cpu", **_common(dense_dtype="int4", sketch_dtype="int4"))
    store.reserve(100)
    assert store._dense.shape == (112, DIM // 2) and store._sp_proj.shape == (112, 16)
    store.add_vectors(_records())
    store.flush()
    assert store._capacity == 112
    jax_store, _ = _both(dense_dtype="int4", sketch_dtype="int4")
    _assert_same(_ask(store, "hybrid", 6), _ask(jax_store, "hybrid", 6))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(candidate_impl="section", dense_dtype="int4"),
        dict(candidate_impl="section", sketch_dtype="int4", dense_dtype="int8"),
        dict(dense_dim=7, dense_dtype="int4"),
        dict(dense_dim=8, sparse_vocab=16, projection_dim=9, sketch_dtype="int4"),
    ],
)
def test_invalid_int4_options_raise_like_jax(kwargs):
    with pytest.raises(ValueError) as want:
        JaxStore(**kwargs)
    with pytest.raises(ValueError) as got:
        DeviceVectorStore(device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
def test_bucket_request_on_int4_gives_the_xla_rows(monkeypatch, search_type):
    """A store asked for the bucket path serves int4 rows through "xla",
    whose rows it must give; the bucket-max path is never entered. The
    capacity (128 rows) is one the bucket kernel serves for int8 rows."""
    from verbatim_rag_tpu_torch.ops import fused_topk

    int4 = dict(dense_dtype="int4", sketch_dtype="int4", block=128)
    xla = DeviceVectorStore(device="cpu", **_common(**int4))
    bucket = DeviceVectorStore(device="cpu", **_common(candidate_impl="bucket", **int4))
    for store in (xla, bucket):
        store.add_vectors(_records())
        store.flush()

    def boom(*args, **kwargs):
        raise AssertionError("an int4 store reached the bucket-max path")

    monkeypatch.setattr(fused_topk, "fused_candidate_topk_v2", boom)
    assert bucket.candidate_impl == "bucket" and fused_topk.bucket_table_width(bucket._capacity)
    _assert_same(_ask(bucket, search_type, 5), _ask(xla, search_type, 5))
