"""BM25 full text and the exact sparse mode in the PyTorch port vs the JAX
package.

The same numpy inputs (or the same records) go through the JAX function and
its port.

Tolerances:
- the analyzer: slots in the same order, counts and lengths equal, against
  the JAX store's `_analyze` with its C++ scanner loaded. The module fixture
  `native_scanner` builds the scanner into this process's own temporary
  directory, so the JAX side never depends on a shared build (without a C++
  compiler the JAX store would take its Python fallback, which orders tied
  terms differently: the fixture then skips);
- `bm25_saturate`, `bm25_idf`: rtol 1e-6; forward-index rows, document
  frequencies and saturated weights of a store: equal;
- `sparse_topk`, `hybrid_topk`, the host `exact_rescore`: rows equal, scores
  at rtol 1e-5 (float32 sums in another order);
- `hybrid_fused_topk_3way` (exact selection) and `hybrid_section_topk_3way`
  (the JAX section kernel in interpret mode, as its own tests run it): rows
  equal, RRF scores bit-equal;
- store queries: rows equal, RRF scores bit-equal, BM25 / sparse scores at
  rtol 1e-5. The candidate depth covers every row, so candidate selection
  does not hang on the sketches' rounding (the two packages sum sketches in
  another order).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.engine import native as jax_native
from verbatim_rag_tpu.engine import store as jax_store_mod
from verbatim_rag_tpu.engine.store import DeviceVectorStore as JaxStore
from verbatim_rag_tpu.ops import hybrid as jax_hybrid
from verbatim_rag_tpu.ops import section as jax_section
from verbatim_rag_tpu.ops import sparse as jax_sparse
from verbatim_rag_tpu.ops import sparse_projected as jax_sp
from verbatim_rag_tpu.ops.dense import quantize_rows_int8 as jax_quantize
from verbatim_rag_tpu_torch.engine import analyzer
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
from verbatim_rag_tpu_torch.ops import hybrid, section, sparse
from verbatim_rag_tpu_torch.ops import sparse_projected as sp

VOCAB = 1 << 17
t = torch.from_numpy

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
# native/Makefile's CXXFLAGS.
NATIVE_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread"]


@pytest.fixture(scope="module")
def native_scanner(tmp_path_factory):
    """The JAX package's C++ host library, built into this process's own
    directory and loaded in place of the shared `native/libverbatim_host.so`.

    Test processes that build the shared library at once can read it half
    written; the JAX loader then falls back to numpy for the rest of the
    process, and its BM25 analyzer orders tied terms otherwise than the
    scanner the port follows (ROADMAP.md §3). Nothing shared is written here.
    """
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler: the JAX store's analyzer would take its Python fallback, "
                    "whose term order the port does not follow (ROADMAP.md §3)")
    lib = tmp_path_factory.mktemp("native") / "libverbatim_host.so"
    subprocess.run([cxx, *NATIVE_FLAGS, "-o", str(lib), str(NATIVE_DIR / "verbatim_host.cpp")],
                   check=True, capture_output=True)
    saved = (jax_native._LIB_PATH, jax_native._lib, jax_native._lib_failed)
    with jax_native._lock:
        jax_native._LIB_PATH, jax_native._lib, jax_native._lib_failed = str(lib), None, False
    assert jax_native.available(), "the JAX host library built but did not load"
    yield
    with jax_native._lock:
        jax_native._LIB_PATH, jax_native._lib, jax_native._lib_failed = saved


pytestmark = pytest.mark.usefixtures("native_scanner")


def _wide_tied_text(n_terms: int, repeats: int = 2) -> str:
    """A text of ``n_terms`` distinct words, each ``repeats`` times (tied
    counts), words shuffled so first occurrences are not in slot order."""
    rng = np.random.default_rng(n_terms)
    words = [f"term{i}x" for i in range(n_terms)] * repeats
    return " ".join(rng.permutation(words))


ANALYZER_TEXTS = [
    "Zeta alpha beta alpha Beta GAMMA zeta",
    "",
    "   ...   ",
    "Ünïcode wörds — the Kelvin sign K, İstanbul, ASCII 123abc! ok",
    "a" * 300 + " " + "a" * 256 + " " + "a" * 255 + "b",  # the 256-byte token cap
    "tab\tnew\nline\x00nul\ud800surrogate",
    " ".join(["wind"] * 700),
    _wide_tied_text(300),  # more than full_text_max_nnz unique terms, tied counts
    _wide_tied_text(4095, 1),  # one below the scanner's limit
    _wide_tied_text(5000, 1),  # past it: the JAX store's Python fallback
]


def _jax_analyze(text: str, vocab: int):
    return jax_store_mod._analyze(text, vocab)


@pytest.mark.parametrize("i", range(len(ANALYZER_TEXTS)))
def test_analyzer_matches_jax(i):
    text = ANALYZER_TEXTS[i]
    ids, tfs, dl = analyzer.analyze(text, VOCAB)
    e_ids, e_tfs, e_dl = _jax_analyze(text, VOCAB)
    assert ids.dtype == np.int32 and tfs.dtype == np.int32 and dl == e_dl
    np.testing.assert_array_equal(ids, e_ids)
    np.testing.assert_array_equal(tfs, e_tfs)


def test_analyzer_orders_terms_by_first_occurrence():
    """The scanner's order, not the fallback's: slots as the words first
    appear, and the fallback exactly at and past 4096 unique slots."""
    ids, tfs, dl = analyzer.analyze("zeta alpha beta alpha", VOCAB)
    expected = [analyzer.fnv1a(w) % (VOCAB - 1) + 1 for w in ("zeta", "alpha", "beta")]
    assert ids.tolist() == expected and tfs.tolist() == [1, 2, 1] and dl == 4
    ids, _, _ = analyzer.analyze(_wide_tied_text(5000, 1), VOCAB)
    assert (np.diff(ids) > 0).all()


@pytest.mark.parametrize("chunk", [3, analyzer.CHUNK_TEXTS])
def test_analyze_texts_matches_one_text_at_a_time(monkeypatch, chunk):
    monkeypatch.setattr(analyzer, "CHUNK_TEXTS", chunk)
    slots, counts, offsets, lengths = analyzer.analyze_texts(ANALYZER_TEXTS, 4096)
    assert offsets.shape == (len(ANALYZER_TEXTS) + 1,)
    for i, text in enumerate(ANALYZER_TEXTS):
        ids, tfs, dl = analyzer.analyze(text, 4096)
        np.testing.assert_array_equal(slots[offsets[i] : offsets[i + 1]], ids)
        np.testing.assert_array_equal(counts[offsets[i] : offsets[i + 1]], tfs)
        assert lengths[i] == dl


# -- ops/sparse.py ---------------------------------------------------------------------


def _forward_index(rng, n, m, vocab, pad=True):
    ids = rng.integers(1, vocab, size=(n, m)).astype(np.int32)
    w = rng.random((n, m), dtype=np.float32)
    if pad:
        nnz = rng.integers(1, m + 1, size=(n, 1))
        dead = np.arange(m)[None, :] >= nnz
        ids[dead], w[dead] = 0, 0.0
    return ids, w


@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (2.0, 0.3)])
def test_bm25_saturate_and_idf_match_jax(k1, b):
    rng = np.random.default_rng(0)
    tf = rng.integers(0, 9, size=(50, 16)).astype(np.int32)
    dl = rng.integers(1, 200, size=50).astype(np.float32)
    avgdl = np.float32(dl.mean())
    expected = np.asarray(jax_sparse.bm25_saturate(jnp.asarray(tf), jnp.asarray(dl), jnp.float32(avgdl), k1, b))
    got = sparse.bm25_saturate(t(tf), t(dl), torch.tensor(avgdl), k1, b).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    df = rng.integers(0, 40, size=300).astype(np.int64)
    np.testing.assert_allclose(
        sparse.bm25_idf(t(df), 40).numpy(),
        np.asarray(jax_sparse.bm25_idf(jnp.asarray(df), jnp.asarray(40))),
        rtol=1e-6,
    )


def test_densify_queries_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, size=(4, 9)).astype(np.int32)
    ids[:, -2:] = ids[:, :2]  # repeated terms add up
    w = rng.random((4, 9), dtype=np.float32)
    np.testing.assert_array_equal(
        sparse.densify_queries(t(ids), t(w), 50).numpy(),
        np.asarray(jax_sparse.densify_queries(jnp.asarray(ids), jnp.asarray(w), 50)),
    )


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 7, 40])
def test_sparse_topk_matches_jax(k, masked):
    rng = np.random.default_rng(k)
    ids, w = _forward_index(rng, 256, 12, 200)
    q = np.zeros((5, 200), np.float32)
    q[:, rng.integers(1, 200, size=30)] = rng.random(30, dtype=np.float32)
    q[4] = 0.0  # a query with no terms: no hits
    mask = np.ones(256, bool)
    if masked:
        mask[::3] = False
    jmask, pmask = (jnp.asarray(mask), t(mask)) if masked else (None, None)
    e_scores, e_rows = jax_sparse.sparse_topk(jnp.asarray(ids), jnp.asarray(w), jnp.asarray(q), k, jmask, block=64)
    g_scores, g_rows = sparse.sparse_topk(t(ids), t(w), t(q), k, pmask, block=64)
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    np.testing.assert_allclose(g_scores.numpy(), np.asarray(e_scores), rtol=1e-5)
    assert (g_rows[4] == -1).all()


def test_hybrid_topk_matches_jax():
    rng = np.random.default_rng(3)
    n, d = 512, 24
    dense = rng.normal(size=(n, d)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    ids, w = _forward_index(rng, n, 10, 300)
    dq = dense[:6] + 0.1 * rng.normal(size=(6, d)).astype(np.float32)
    dq /= np.linalg.norm(dq, axis=1, keepdims=True)
    q = np.zeros((6, 300), np.float32)
    q[np.arange(6)[:, None], ids[:6, :4]] = 1.0
    mask = np.ones(n, bool)
    mask[5:50] = False
    kw = dict(k=8, dense_weight=0.3, sparse_weight=0.7, rrf_k=20, block=128)
    e_scores, e_rows = jax_hybrid.hybrid_topk(
        jnp.asarray(dense), jnp.asarray(ids), jnp.asarray(w), jnp.asarray(dq), jnp.asarray(q),
        mask=jnp.asarray(mask), **kw,
    )
    g_scores, g_rows = hybrid.hybrid_topk(t(dense), t(ids), t(w), t(dq), t(q), mask=t(mask), **kw)
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    np.testing.assert_allclose(g_scores.numpy(), np.asarray(e_scores), rtol=1e-5)


def test_project_queries_and_host_rescore_match_jax():
    rng = np.random.default_rng(4)
    proj = sp.projection_matrix(300, 16, 2)
    q = rng.random((3, 300), dtype=np.float32)
    np.testing.assert_array_equal(sp.project_queries(q, proj), jax_sp.project_queries(q, proj))
    ids, w = _forward_index(rng, 40, 8, 300)
    rows = rng.integers(0, 40, size=(3, 11))
    rows[0, :3] = -1
    got = sp.exact_rescore(rows, ids, w, q)
    expected = jax_sp.exact_rescore(rows, ids, w, q)
    assert np.isneginf(got[0, :3]).all() and np.isneginf(expected[0, :3]).all()
    np.testing.assert_allclose(got[:, 3:], expected[:, 3:], rtol=1e-5)


# -- ops/hybrid.py, ops/section.py: the 3-way programs ------------------------------------


def _three_way_inputs(seed, n, b=5, d=16, dp=32):
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    dense = unit(rng.normal(size=(n, d)))
    sketch = rng.normal(size=(n, dp)).astype(np.float32)
    ft_sketch = rng.normal(size=(n, dp)).astype(np.float32)
    sp_ids, sp_w = _forward_index(rng, n, 8, 64, pad=False)
    ft_ids, ft_w = _forward_index(rng, n, 16, 4096)
    dq = unit(rng.normal(size=(b, d)))
    sq = rng.normal(size=(b, dp)).astype(np.float32)
    fq = rng.normal(size=(b, dp)).astype(np.float32)
    q_ids = sp_ids[:b, :6].copy()
    q_w = (rng.random((b, 6)) + 0.1).astype(np.float32)
    fq_ids = ft_ids[b : 2 * b, :10].copy()
    fq_w = (rng.random((b, 10)) + 0.1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[100:110] = False
    return dict(
        corpora=(dense, sketch, ft_sketch), index=(sp_ids, sp_w, ft_ids, ft_w),
        queries=(dq, sq, fq), terms=(q_ids, q_w, fq_ids, fq_w), mask=mask,
    )


@pytest.mark.parametrize("rescore_impl", ["scan", "oneshot", "pallas"])
@pytest.mark.parametrize("depth", [32, 512])
def test_hybrid_fused_topk_3way_matches_jax(depth, rescore_impl):
    x = _three_way_inputs(depth, 512)
    (dense, sketch, ft_sketch), (sp_ids, sp_w, ft_ids, ft_w) = x["corpora"], x["index"]
    (dq, sq, fq), (q_ids, q_w, fq_ids, fq_w) = x["queries"], x["terms"]
    kw = dict(k=10, fetch_k=20, depth=depth, dense_weight=0.5, sparse_weight=0.2,
              ft_weight=0.3, rrf_k=60, exact_topk=True)
    arrays = (dense, sketch, sp_ids, sp_w, ft_sketch, ft_ids, ft_w, dq, sq, q_ids, q_w, fq, fq_ids, fq_w)
    e_scores, e_rows = jax_hybrid.hybrid_fused_topk_3way(
        *map(jnp.asarray, arrays), mask=jnp.asarray(x["mask"]), rescore_impl="scan", **kw
    )
    g_scores, g_rows = hybrid.hybrid_fused_topk_3way(
        *map(t, arrays), mask=t(x["mask"]), rescore_impl=rescore_impl, **kw
    )
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    np.testing.assert_array_equal(g_scores.numpy(), np.asarray(e_scores))
    assert (g_rows >= 0).all()


@pytest.mark.parametrize("block_cols,depth", [(128, 64), (256, 64), (256, 1000)])
def test_hybrid_section_topk_3way_matches_jax(block_cols, depth):
    n = 2 * block_cols
    x = _three_way_inputs(block_cols + depth, n)
    codes = [jax_quantize(c) for c in x["corpora"]]
    (sp_ids, sp_w, ft_ids, ft_w), (dq, sq, fq) = x["index"], x["queries"]
    q_ids, q_w, fq_ids, fq_w = x["terms"]
    kw = dict(k=10, fetch_k=20, depth=depth, dense_weight=0.5, sparse_weight=0.2,
              ft_weight=0.3, rrf_k=60)
    (d8, ds), (s8, ss), (f8, fs) = codes
    j = jnp.asarray
    e_scores, e_rows = jax_section.hybrid_section_topk_3way(
        j(d8.T.copy()), j(s8.T.copy()), j(sp_ids), j(sp_w), j(f8.T.copy()), j(ft_ids), j(ft_w),
        j(dq), j(sq), j(q_ids), j(q_w), j(fq), j(fq_ids), j(fq_w), mask=j(x["mask"]),
        dense_scale=j(ds), sketch_scale=j(ss), ft_scale=j(fs), rescore_impl="oneshot",
        block_cols=block_cols, dot_chunk=128, q_block=8, interpret=True, **kw,
    )
    g_scores, g_rows = section.hybrid_section_topk_3way(
        t(d8), t(s8), t(sp_ids), t(sp_w), t(f8), t(ft_ids), t(ft_w),
        t(dq), t(sq), t(q_ids), t(q_w), t(fq), t(fq_ids), t(fq_w), mask=t(x["mask"]),
        dense_scale=t(ds), sketch_scale=t(ss), ft_scale=t(fs), rescore_impl="pallas",
        block_cols=block_cols, **kw,
    )
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    np.testing.assert_array_equal(g_scores.numpy(), np.asarray(e_scores))
    assert (g_rows >= 0).sum() > 0


# -- the store's full-text tier and exact mode ---------------------------------------------

WORDS = [f"w{i}" for i in range(60)] + ["solar", "wind", "battery", "grid", "panels"]
FT = dict(dense_dim=32, sparse_vocab=500, sparse_max_nnz=16, enable_full_text=True,
          full_text_vocab=4096, full_text_max_nnz=32, projection_dim=64, block=1024,
          approx_topk=False)


def _corpus(n=90, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    texts = [" ".join(rng.choice(WORDS, size=rng.integers(3, 45), p=p)) for _ in range(n)]
    texts[7] = texts[3]  # an exact duplicate: BM25 scores tie
    texts[11] = _wide_tied_text(40)  # more unique terms than full_text_max_nnz
    dense = rng.normal(size=(n, 32)).astype(np.float32)
    records = []
    for i, text in enumerate(texts):
        ids = rng.choice(np.arange(1, 500), size=12, replace=False)
        records.append(dict(
            id=f"r{i}", text=text, metadata={"document_id": f"d{i % 4}"}, dense=dense[i],
            sparse={int(a): float(b) for a, b in zip(ids, rng.random(12) + 0.05)},
        ))
    return records


def _queries(records, b=6, seed=1):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, len(records), size=b)
    dense = np.stack([records[i]["dense"] for i in src]) + 0.3
    sparse_q = [dict(list(records[i]["sparse"].items())[:5]) for i in src]
    text = [" ".join(records[i]["text"].split()[:6]) for i in src]
    text[-1] = "nothing matches zzz"
    return dense.astype(np.float32), sparse_q, text


def _pair(flushes=(40, 30, 20), extra=0, **options):
    """Both stores over the same records, flushed in ``flushes`` batches;
    ``extra`` more records are made but left out."""
    records = _corpus(sum(flushes) + extra)
    kwargs = {**FT, **options}
    jax_store, port_store = JaxStore(**kwargs), DeviceVectorStore(device="cpu", **kwargs)
    start = 0
    for n in flushes:
        for store in (jax_store, port_store):
            store.add_vectors(records[start : start + n])
            store.flush()
        start += n
    return jax_store, port_store, records


def _same(got, expected, exact_scores):
    assert [[h.id for h in r] for r in got] == [[h.id for h in r] for r in expected]
    for g_row, e_row in zip(got, expected):
        g = np.array([h.score for h in g_row], np.float32)
        e = np.array([h.score for h in e_row], np.float32)
        if exact_scores:
            np.testing.assert_array_equal(g, e)
        else:
            np.testing.assert_allclose(g, e, rtol=1e-5)


def _ask(store, records, methods, **kwargs):
    dense, sparse_q, text = _queries(records)
    return store.query_batch(
        dense_queries=dense if "dense" in methods else None,
        sparse_queries=sparse_q if "sparse" in methods else None,
        text_queries=text if "full_text" in methods else None,
        search_type=methods[0] if len(methods) == 1 else None, **kwargs,
    )


def test_full_text_ingest_matches_jax():
    """Forward-index rows (the heaviest 32 terms of the wide chunk picked in
    the same order), raw counts, lengths, document frequencies and the
    saturated weights at the last flush's avgdl."""
    jax_store, port_store, _ = _pair()
    for name in ("_ft_ids", "_ft_tf"):
        np.testing.assert_array_equal(getattr(port_store, name).numpy(), np.asarray(getattr(jax_store, name)))
    np.testing.assert_array_equal(port_store._doc_len, jax_store._doc_len)
    np.testing.assert_array_equal(port_store._doc_freq, jax_store._doc_freq)
    np.testing.assert_array_equal(port_store._ft_w.numpy(), np.asarray(jax_store._ft_w))
    assert (port_store._ft_tf[11] > 0).sum() == 32


@pytest.mark.parametrize("top_k", [1, 5, 20])
@pytest.mark.parametrize(
    "methods", [("full_text",), ("dense", "sparse", "full_text"), ("dense", "full_text")],
)
def test_full_text_queries_match_jax(methods, top_k):
    jax_store, port_store, records = _pair()
    expected = _ask(jax_store, records, methods, top_k=top_k)
    got = _ask(port_store, records, methods, top_k=top_k)
    assert any(got)
    _same(got, expected, exact_scores=len(methods) > 1)


def test_three_way_hybrid_on_the_int8_section_path(monkeypatch):
    """int8 tier: "auto" → section; the 3-way batch is one section call
    with three arms (the JAX store runs its kernel in interpret mode)."""
    monkeypatch.setenv("VERBATIM_SECTION_INTERPRET", "1")
    calls = []
    real = section.section_bucket_tables

    def counted(corpora, *args, **kwargs):
        calls.append(len(corpora))
        return real(corpora, *args, **kwargs)

    monkeypatch.setattr(section, "section_bucket_tables", counted)
    options = dict(dense_dtype="int8", sketch_dtype="int8", approx_topk=True, block=8192,
                   rescore_depth=100)
    jax_store, port_store, records = _pair(**options)
    assert port_store.candidate_impl == jax_store.candidate_impl == "section"
    methods = ("dense", "sparse", "full_text")
    for weights in (None, {"dense": 0.2, "sparse": 0.3, "full_text": 0.5}):
        expected = _ask(jax_store, records, methods, top_k=8, hybrid_weights=weights)
        got = _ask(port_store, records, methods, top_k=8, hybrid_weights=weights)
        _same(got, expected, exact_scores=True)
    assert calls == [3, 3]


@pytest.mark.parametrize("methods", [("sparse",), ("full_text",), ("dense", "sparse", "full_text")])
def test_exact_mode_matches_jax(methods):
    """sparse_mode="exact": the forward-index scan, no sketches; a hybrid
    fuses its methods on the host."""
    jax_store, port_store, records = _pair(sparse_mode="exact")
    assert port_store._sp_proj is None and port_store._ft_proj is None
    expected = _ask(jax_store, records, methods, top_k=6)
    got = _ask(port_store, records, methods, top_k=6)
    assert any(got)
    _same(got, expected, exact_scores=len(methods) > 1)


def test_exact_scan_refused_above_its_row_limit(monkeypatch):
    for cls in (JaxStore, DeviceVectorStore):
        monkeypatch.setattr(cls, "EXACT_SCAN_MAX_ROWS", 50)
    jax_store, port_store, records = _pair(sparse_mode="exact")
    for store in (jax_store, port_store):
        with pytest.raises(RuntimeError, match="allow_exact_at_scale"):
            _ask(store, records, ("full_text",), top_k=3)
    allowed = _pair(sparse_mode="exact", allow_exact_at_scale=True)
    _same(_ask(allowed[1], records, ("sparse",), top_k=3),
          _ask(allowed[0], records, ("sparse",), top_k=3), exact_scores=False)


def test_delete_drops_document_frequencies_like_jax():
    jax_store, port_store, records = _pair()
    before = port_store._doc_freq.copy()
    gone = ["r3", "r11", "r40", "missing"]
    for store in (jax_store, port_store):
        store.delete(gone)
        store.delete(["r40"])  # already tombstoned: no second decrement
    np.testing.assert_array_equal(port_store._doc_freq, jax_store._doc_freq)
    dropped = np.zeros_like(before)
    for rid in ("r3", "r11", "r40"):
        ids, tf, _ = port_store._full_text_rows([records[int(rid[1:])]["text"]])
        np.add.at(dropped, ids[tf > 0], 1)
    np.testing.assert_array_equal(before - port_store._doc_freq, dropped)
    got = _ask(port_store, records, ("full_text",), top_k=10)
    _same(got, _ask(jax_store, records, ("full_text",), top_k=10), exact_scores=False)
    assert not {"r3", "r11", "r40"} & {h.id for r in got for h in r}


def test_delete_counts_a_repeated_id_once():
    """One id named twice in a delete drops its row's terms once (the JAX
    store drops them twice: ROADMAP.md §3, divergences by choice)."""
    _, port_store, records = _pair(flushes=(30,))
    before = port_store._doc_freq.copy()
    port_store.delete(["r5", "r5"])
    ids, tf, _ = port_store._full_text_rows([records[5]["text"]])
    dropped = np.zeros_like(before)
    np.add.at(dropped, ids[tf > 0], 1)
    np.testing.assert_array_equal(before - port_store._doc_freq, dropped)


def test_reserve_and_compact_match_jax():
    jax_store, port_store, records = _pair(flushes=(30,), extra=30)
    for store in (jax_store, port_store):
        store.reserve(5000)
        store.add_vectors(records[30:60])
        store.delete(["r1", "r2", "r35"])
    assert port_store._bm25_stale is False  # reserve's stale weights refreshed by the flush
    assert port_store._capacity == jax_store._capacity == 5120
    idf_before = port_store._bm25_query_sparse(["w0 w1 solar wind"])
    assert port_store.compact() == jax_store.compact() == 3
    assert port_store.compact() == 0
    assert port_store.count() == jax_store.count() == 57
    assert port_store._bm25_query_sparse(["w0 w1 solar wind"]) == idf_before
    np.testing.assert_array_equal(port_store._doc_freq, jax_store._doc_freq)
    for methods in (("full_text",), ("dense", "sparse", "full_text")):
        _same(_ask(port_store, records, methods, top_k=5), _ask(jax_store, records, methods, top_k=5),
              exact_scores=len(methods) > 1)


def test_auto_compact_threshold_matches_jax():
    jax_store, port_store, records = _pair(flushes=(40,), auto_compact_threshold=0.1)
    for store in (jax_store, port_store):
        store.delete(["r0", "r1"])  # 5%: tombstones only
    assert port_store.size == jax_store.size == 40
    for store in (jax_store, port_store):
        store.delete(["r2", "r3"])  # 10%: compacted
    assert port_store.size == jax_store.size == 36
    assert port_store._ids == jax_store._ids
    np.testing.assert_array_equal(port_store._doc_freq, jax_store._doc_freq)


def test_text_queries_ignored_without_full_text():
    """A store built without enable_full_text ignores text queries beside
    other methods, and refuses them alone, as the JAX store does."""
    options = dict(enable_full_text=False)
    jax_store, port_store, records = _pair(flushes=(30,), **options)
    for methods in (("dense", "sparse", "full_text"), ("dense", "full_text")):
        expected = _ask(jax_store, records, methods, top_k=4)
        got = _ask(port_store, records, methods, top_k=4)
        assert any(got)
        _same(got, expected, exact_scores=len(methods) > 2)
    for store in (jax_store, port_store):
        with pytest.raises(ValueError, match="full_text"):
            store.query_batch(text_queries=["solar"], top_k=3)


def test_full_text_options_construct(caplog):
    """Every keyword of the JAX store's constructor is taken, and the exact
    mode warns at construction as the JAX store does."""
    with caplog.at_level(logging.WARNING):
        store = DeviceVectorStore(
            device="cpu", enable_full_text=True, full_text_vocab=1024, full_text_max_nnz=8,
            bm25_k1=1.5, bm25_b=0.5, sparse_mode="exact", auto_compact_threshold=0.3,
            allow_exact_at_scale=True, sparse_ids_dtype="int16",
        )
    assert "sparse_mode='exact'" in caplog.text
    assert store._doc_freq.shape == (1024,) and store.bm25_k1 == 1.5
