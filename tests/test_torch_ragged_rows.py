"""Rows of any width in the PyTorch port vs the JAX package.

The table kernels (section, bucket-max v2 and v1) load rows by TMA, whose
row stride must be a multiple of 16 bytes; the JAX kernels take any width.
The port keeps its store's dense and sketch rows at a 16-byte pitch
(`fused_topk.pitched_zeros`: [n, d] views of [n, pitch] buffers) and hands
the kernels those views in place. These tests hold, at widths that are not
a 16-byte multiple (int8 300 — GloVe's 300 dims —, bf16 300, float32 301,
each pitched to 304 columns):

- the JAX kernels (Pallas in interpret mode) and the port's plain versions
  on the same numpy inputs, the port once on packed tensors and once on
  pitched views: int8 tables bit-equal (compared as int32 views), bf16 and
  float32 values within 2⁻¹⁵·|q| (v1 float32 2⁻¹⁸·|q|) and rows equal
  except in buckets whose two best scores lie within that, as the aligned
  parity tests hold them;
- a 300-d int8 store on "section" against its twin whose rows are the same
  rows zero-padded to 304 columns: ids and scores equal (the zero columns
  leave norms, int8 scales, codes and every dot unchanged; the dense rows
  and queries here hold few mantissa bits, so their norms are exact
  whatever the order of the sums), and against the JAX store (rows equal,
  RRF scores bit-equal);
- save / load across packages at 300-d: saved arrays [n, 300], answers
  equal to the same package's;
- the pure planning functions at their edges: pitches of 1, 15, 16 and 17
  bytes; launch slices at batch × heads = 65,535 and 65,536.

The card tests of the same paths are in `test_torch_cuda_kernels.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.engine.store import DeviceVectorStore as JaxStore
from verbatim_rag_tpu.ops import dense as jax_dense
from verbatim_rag_tpu.ops import fused_topk as jax_ft
from verbatim_rag_tpu.ops import section as jax_section
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
from verbatim_rag_tpu_torch.ops import cuda_build
from verbatim_rag_tpu_torch.ops import fused_topk as ft
from verbatim_rag_tpu_torch.ops import section as sec

LANE = 128
#: (row dtype, columns): widths whose rows are not a 16-byte multiple, all
#: pitched to 304 columns.
RAGGED = [("int8", 300), ("bfloat16", 300), ("float32", 301)]
PITCH = 304
JAX_DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
LIMITS = {"bfloat16": 2.0**-15, "float32": 2.0**-15}
V1_LIMITS = {"bfloat16": 2.0**-15, "float32": 2.0**-18}


@pytest.fixture(autouse=True)
def _section_interpret(monkeypatch):
    monkeypatch.setenv("VERBATIM_SECTION_INTERPRET", "1")


def _inputs(n, d, b, seed):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.normal(size=(b, d)).astype(np.float32)  # a ragged batch
    mask = np.ones(n, bool)
    mask[::7] = False
    mask[5 * LANE : 6 * LANE] = False  # v1's bucket 5 dead
    mask[np.arange(n) % LANE == 9] = False  # lane 9 of every block: v2's and section's
    return corpus, q, mask


def _rows(corpus, dtype):
    """The stored rows as numpy: int8 codes and scales, or float32 values."""
    if dtype == "int8":
        return jax_dense.quantize_rows_int8(corpus)
    return corpus, None


def _port_rows(rows, dtype, layout):
    """The rows as the port's ops take them: a packed tensor, or a [n, d]
    view of a buffer at the 16-byte pitch (the store's layout)."""
    t = torch.from_numpy(rows)
    if dtype != "int8":
        t = t.to(getattr(torch, dtype))
    if layout == "pitched":
        view = ft.pitched_zeros(t.shape[0], t.shape[1], t.dtype)
        view.copy_(t)
        assert view.stride(0) == PITCH and not view.is_contiguous()
        t = view
    return t


def _jax_rows(rows, dtype):
    return jnp.asarray(rows) if dtype == "int8" else jnp.asarray(rows).astype(JAX_DTYPES[dtype])


def _assert_tables(got, expected, corpus, q, mask, dtype, block, limit):
    """(values, global rows) pairs: int8 bit-equal; floats within ``limit``
    of |q| and rows equal except in buckets whose two best are that close.
    A bucket holds the rows of one lane of a ``block`` (section, v2), or
    with ``block`` None 128 consecutive rows (v1)."""
    (g_vals, g_rows), (e_vals, e_rows) = got, expected
    if dtype == "int8":
        np.testing.assert_array_equal(g_vals.numpy().view(np.int32), e_vals.numpy().view(np.int32))
        np.testing.assert_array_equal(g_rows.numpy(), e_rows.numpy())
        return
    live = e_vals > -1e29
    assert torch.equal(live, g_vals > -1e29)
    qc = torch.from_numpy(q).to(getattr(torch, dtype)).float()
    tol = limit * qc.norm(dim=1, keepdim=True).expand_as(g_vals)
    assert bool(((g_vals - e_vals).abs() <= tol)[live].all())
    c = torch.from_numpy(corpus).to(getattr(torch, dtype)).float()
    scores = torch.where(torch.from_numpy(mask), qc @ c.T, -1e30)
    if block is None:
        top2 = scores.reshape(q.shape[0], -1, LANE).topk(2, dim=2).values
        gap = top2[..., 0] - top2[..., 1]
    else:
        top2 = scores.reshape(q.shape[0], -1, block // LANE, LANE).topk(2, dim=2).values
        gap = top2[:, :, 0] - top2[:, :, 1]
    near = gap.reshape(q.shape[0], -1).abs() <= tol
    assert bool(((g_rows == e_rows) | ~live | near).all())


def _decode(table, block):
    vals, pos = sec.unpack_table(table)
    cols = torch.arange(table.shape[1])
    return vals, (cols // LANE) * block + pos * LANE + cols % LANE


@pytest.mark.parametrize("layout", ["packed", "pitched"])
@pytest.mark.parametrize("dtype,d", RAGGED)
def test_section_tables_at_ragged_widths_match_jax(dtype, d, layout):
    n, block = 1024, 256
    corpus, q, mask = _inputs(n, d, 13, seed=d)
    rows, scale = _rows(corpus, dtype)
    scales = () if scale is None else (scale,)
    (expected,) = jax_section.section_bucket_tables(
        (_jax_rows(rows, dtype).T,), (jnp.asarray(q),), jnp.asarray(mask),
        scales=tuple(jnp.asarray(s) for s in scales), block_cols=block, dot_chunk=128, q_block=8,
        interpret=True,
    )
    (got,) = sec.section_bucket_tables(
        (_port_rows(rows, dtype, layout),), (torch.from_numpy(q),), torch.from_numpy(mask),
        scales=tuple(torch.from_numpy(s) for s in scales), block_cols=block,
    )
    expected = torch.from_numpy(np.array(expected))
    assert got.shape == expected.shape == (13, n // block * LANE)
    _assert_tables(
        _decode(got, block), _decode(expected, block), corpus, q, mask, dtype, block,
        LIMITS.get(dtype),
    )
    assert (got[:, 9::LANE] <= -1e29).all()  # the dead lane


@pytest.mark.parametrize("layout", ["packed", "pitched"])
@pytest.mark.parametrize("dtype,d", RAGGED)
def test_bucket_max_v2_at_ragged_widths_matches_jax(dtype, d, layout):
    n = 2048
    corpus, q, mask = _inputs(n, d, 5, seed=d + 1)
    rows, scale = _rows(corpus, dtype)
    e_vals, e_rows = jax_ft.matmul_bucket_max_v2(
        _jax_rows(rows, dtype), jnp.asarray(q), jnp.asarray(mask), interpret=True,
        scale=None if scale is None else jnp.asarray(scale),
    )
    got = ft.matmul_bucket_max_v2(
        _port_rows(rows, dtype, layout), torch.from_numpy(q), torch.from_numpy(mask),
        scale=None if scale is None else torch.from_numpy(scale),
    )
    expected = (torch.from_numpy(np.array(e_vals)), torch.from_numpy(np.array(e_rows)))
    _assert_tables(got, expected, corpus, q, mask, dtype, ft.choose_block_rows(n), LIMITS.get(dtype))
    assert (got[0][:, 9::LANE] <= -1e29).all()  # the dead lane


@pytest.mark.parametrize("layout", ["packed", "pitched"])
@pytest.mark.parametrize("dtype,d", RAGGED[1:])
def test_bucket_max_v1_at_ragged_widths_matches_jax(dtype, d, layout):
    n = 2048
    corpus, q, mask = _inputs(n, d, 7, seed=d + 2)
    e_vals, e_rows = jax_ft.matmul_bucket_max(
        _jax_rows(corpus, dtype), jnp.asarray(q), jnp.asarray(mask), interpret=True
    )
    got = ft.matmul_bucket_max(_port_rows(corpus, dtype, layout), torch.from_numpy(q), torch.from_numpy(mask))
    expected = (torch.from_numpy(np.array(e_vals)), torch.from_numpy(np.array(e_rows)))
    _assert_tables(got, expected, corpus, q, mask, dtype, None, V1_LIMITS[dtype])
    assert (got[0][:, 5] == -1e30).all() and (got[1][:, 5] == 5 * LANE + 127).all()


# -- the kernels' operands ---------------------------------------------------------------


def test_kernel_rows_take_a_pitched_view_of_any_width():
    """`check_kernel_rows` returns on a pitched int8 300-column view, where
    the parent raised for any width off a 16-byte multiple; it refuses only
    rows whose starts are not a 16-byte multiple apart (a packed 300-column
    tensor), a misaligned base or a column stride."""
    view = ft.pitched_zeros(64, 300, torch.int8)
    assert ft.check_kernel_rows(view, "section", "section") == 300
    assert ft.row_pitch_bytes(view) == 304 and ft.is_pitched(view)
    for bad in (
        torch.zeros(64, 300, dtype=torch.int8),  # pitch 300
        ft.pitched_zeros(65, 300, torch.int8)[1:],  # base 304 bytes in: aligned, so taken
        torch.zeros(64, 320, dtype=torch.int8)[:, 1:301],  # base off by one byte
        torch.zeros(300, 64, dtype=torch.int8).t(),  # column stride 64
    ):
        if ft.is_pitched(bad):
            assert ft.check_kernel_rows(bad, "section") == 300
            continue
        with pytest.raises(ValueError, match="16-byte multiple"):
            ft.check_kernel_rows(bad, "section")
    with pytest.raises(TypeError, match="float32 rows"):
        ft.check_kernel_rows(ft.pitched_zeros(4, 300, torch.float16), "section")


@pytest.mark.parametrize("dtype,d", RAGGED)
def test_kernel_operands_read_pitched_rows_in_place(dtype, d):
    """A pitched view reaches the launch as it is (same storage, no copy
    counted); a caller's packed rows are copied to the pitch once, equal to
    them; queries are prepared and pitched alike."""
    tdtype = getattr(torch, dtype)
    packed = torch.arange(40 * d).reshape(40, d).remainder(97).sub(48).to(tdtype)
    view = ft.pitched_zeros(40, d, tdtype)
    view.copy_(packed)
    q = torch.randn(9, d)
    copies = ft.corpus_copies
    corpus, qp, q_scale, row_bytes = ft.kernel_operands(view, q, "section")
    assert corpus.data_ptr() == view.data_ptr() and ft.corpus_copies == copies
    assert row_bytes == d * view.element_size() and ft.is_pitched(qp)
    assert qp.shape == (9, d) and ft.row_pitch_bytes(qp) == PITCH * view.element_size()
    assert (q_scale is not None) == (dtype == "int8")
    corpus, qp2, _, _ = ft.kernel_operands(packed, q, "section")
    assert ft.corpus_copies == copies + 1
    assert ft.is_pitched(corpus) and corpus.data_ptr() != packed.data_ptr()
    assert torch.equal(corpus, packed) and torch.equal(qp2, qp)
    ft.corpus_copies = copies


@pytest.mark.parametrize(
    "cols,element_size,pitch",
    [(1, 1, 16), (15, 1, 16), (16, 1, 16), (17, 1, 32), (300, 1, 304),
     (7, 2, 8), (8, 2, 8), (9, 2, 16), (300, 2, 304), (3, 4, 4), (4, 4, 4), (5, 4, 8), (301, 4, 304)],
)
def test_pitch_columns_at_the_edges(cols, element_size, pitch):
    """Rows of 1, 15, 16 and 17 bytes (and their bf16 / float32 kin) get the
    next 16-byte multiple as their pitch; a buffer at that pitch is a view
    only when the width is not one."""
    assert ft.pitch_columns(cols, element_size) == pitch
    dtype = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}[element_size]
    t = ft.pitched_zeros(3, cols, dtype)
    assert t.shape == (3, cols) and t.stride() == (pitch, 1) and ft.is_pitched(t)
    assert t.is_contiguous() == (pitch == cols)
    assert ft.resident_bytes(t) == 3 * pitch * element_size
    assert float(t.float().abs().sum()) == 0.0


@pytest.mark.parametrize(
    "batch,heads,chunks",
    [
        (65535, 1, [(0, 65535)]),
        (65536, 1, [(0, 65535), (65535, 65536)]),
        (13107, 5, [(0, 13107)]),  # batch × heads = 65,535
        (4096, 16, [(0, 4095), (4095, 4096)]),  # 65,536
        (5461, 12, [(0, 5461)]),  # 65,532
        (5462, 12, [(0, 5461), (5461, 5462)]),  # 65,544: the card's grid check
        (65600, 1, [(0, 65535), (65535, 65600)]),  # the card's rescore check
        (3 * 65535 + 1, 1, [(0, 65535), (65535, 131070), (131070, 196605), (196605, 196606)]),
        (0, 12, []),
    ],
)
def test_grid_chunks_at_the_limit(batch, heads, chunks):
    """Launch slices of the flash and rescore wrappers: every slice's batch
    × heads fits gridDim.y, the slices cover the batch in order, and a batch
    that fits is one launch."""
    got = cuda_build.grid_chunks(batch, heads)
    assert got == chunks
    assert all((b1 - b0) * heads <= cuda_build.GRID_Y_MAX for b0, b1 in got)


def test_grid_chunks_refuse_rows_wider_than_the_grid():
    with pytest.raises(ValueError, match="gridDim.y"):
        cuda_build.grid_chunks(4, 65536)
    with pytest.raises(ValueError, match="gridDim.y"):
        cuda_build.grid_chunks(4, 0)


# -- the store ---------------------------------------------------------------------------

N_RECORDS = 200
QUERIES = 12
STORE = dict(sparse_vocab=4096, sparse_max_nnz=8, projection_dim=100, block=8192,
             dense_dtype="int8", sketch_dtype="int8")


def _dyadic(rng, shape):
    """Values k/16 for integers k in [-16, 16]: every sum of squares of a
    row is exact in float32, so its norm does not depend on the order of the
    sums or on zero columns."""
    return (rng.integers(-16, 17, size=shape) / 16).astype(np.float32)


def _records(cols, n=N_RECORDS, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, cols), np.float32)
    dense[:, :300] = _dyadic(rng, (n, 300))
    dense[7] = dense[3]  # a duplicate row: scores tie
    ids = rng.integers(1, 4096, size=(n, 8)).astype(np.int32)
    w = rng.random((n, 8), dtype=np.float32)
    return [
        {"id": f"r{i}", "text": f"text {i}", "metadata": {"document_id": f"d{i % 3}"},
         "dense": dense[i], "sparse_arrays": (ids[i], w[i])}
        for i in range(n)
    ]


def _store_queries(cols, seed=1):
    rng = np.random.default_rng(seed)
    dense = np.zeros((QUERIES, cols), np.float32)
    dense[:, :300] = _dyadic(rng, (QUERIES, 300))
    ids = rng.integers(1, 4096, size=(QUERIES, 6)).astype(np.int32)
    ids[:, :3] = np.asarray([r["sparse_arrays"][0][:3] for r in _records(cols)[:QUERIES]])
    return dense, {int(t): 1.0 for t in ids[0]}, [
        {int(t): float(w) for t, w in zip(row, np.linspace(0.2, 1.0, 6))} for row in ids
    ]


def _port_store(cols, records=None, **options):
    store = DeviceVectorStore(dense_dim=cols, device="cpu", **{**STORE, **options})
    store.add_vectors(records or _records(cols))
    store.flush()
    return store


def _answers(store, cols, search_type=None, top_k=10, **kwargs):
    dense, _, sparse = _store_queries(cols)
    out = store.query_batch(
        dense_queries=None if search_type == "sparse" else dense,
        sparse_queries=None if search_type == "dense" else sparse,
        search_type=search_type, top_k=top_k, **kwargs,
    )
    return [[(h.id, h.score) for h in row] for row in out]


def _assert_pitched(store):
    for name in ("_dense", "_sp_proj"):
        t = getattr(store, name)
        assert ft.is_pitched(t) and t.stride(0) == ft.pitch_columns(t.shape[1], t.element_size())


def test_ragged_store_keeps_its_rows_at_a_pitch():
    """The 300-d int8 store (sketch 100) resolves "auto" to "section" as the
    JAX store does; its dense and sketch rows are [cap, d] views at 304 and
    112 bytes a row, through delete, compact, reserve and load; its state
    grows by at most the pitch."""
    store = _port_store(300)
    assert store.candidate_impl == "section"
    assert store._dense.shape == (8192, 300) and store._dense.stride(0) == 304
    assert store._sp_proj.shape == (8192, 100) and store._sp_proj.stride(0) == 112
    _assert_pitched(store)
    dense_bytes = ft.resident_bytes(store._dense)
    assert dense_bytes == 8192 * 304 and dense_bytes / (8192 * 300) <= 304 / 300
    store.delete(["r3", "r11"])
    store.compact()
    _assert_pitched(store)
    store.reserve(3 * 8192)
    assert store._dense.shape == (3 * 8192, 300)
    _assert_pitched(store)


@pytest.mark.parametrize("search_type", [None, "dense", "sparse"])
def test_ragged_store_equals_its_zero_padded_twin(search_type):
    """A 300-d store and its twin, the same rows zero-padded to 304 columns
    (which the aligned path serves): the same ids and scores, bit for bit,
    on the section path (hybrid), and for each arm alone."""
    ragged, twin = _port_store(300), _port_store(304)
    assert ragged.candidate_impl == twin.candidate_impl == "section"
    got = _answers(ragged, 300, search_type)
    assert any(got) and got == _answers(twin, 304, search_type)
    np.testing.assert_array_equal(ragged._dense[:N_RECORDS].numpy(), twin._dense[:N_RECORDS, :300].numpy())
    assert not twin._dense[:, 300:].any()


def test_ragged_store_matches_jax():
    """The 300-d int8 store against the JAX store on the same records (its
    section kernel in interpret mode): dense codes and scales bit-equal,
    hybrid rows equal with bit-equal RRF scores, as at aligned widths."""
    records = _records(300)
    port = _port_store(300, records)
    jax_store = JaxStore(dense_dim=300, **STORE)
    jax_store.add_vectors(records)
    jax_store.flush()
    assert jax_store.candidate_impl == port.candidate_impl == "section"
    np.testing.assert_array_equal(port._dense[:N_RECORDS].numpy(), np.asarray(jax_store._dense[:N_RECORDS]))
    np.testing.assert_array_equal(
        port._dense_scale[:N_RECORDS].numpy().view(np.int32),
        np.array(jax_store._dense_scale[:N_RECORDS]).view(np.int32),
    )
    got, expected = _answers(port, 300, top_k=5), _answers(jax_store, 300, top_k=5)
    assert [[i for i, _ in row] for row in got] == [[i for i, _ in row] for row in expected]
    for g_row, e_row in zip(got, expected):
        np.testing.assert_array_equal(
            np.array([s for _, s in g_row], np.float32), np.array([s for _, s in e_row], np.float32)
        )


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_ragged_store_saves_and_loads_across_packages(tmp_path, saver):
    """At 300-d either package saves [n, 300] arrays (float32 rows, int8
    codes) and the other loads them into its own layout (the port's at the
    pitch) and answers as a load by the saving package does."""
    records = _records(300)
    if saver == "jax":
        store = JaxStore(dense_dim=300, **STORE)
        store.add_vectors(records)
        store.flush()
    else:
        store = _port_store(300, records)
    store.delete(["r5"])
    path = str(tmp_path / "idx")
    store.save(path)
    arrays = np.load(path + ".npz")
    assert arrays["dense"].shape == arrays["dense_i8"].shape == (N_RECORDS, 300)
    port = DeviceVectorStore.load(path, device="cpu")
    jax_loaded = JaxStore.load(path)
    _assert_pitched(port)
    np.testing.assert_array_equal(port._dense[:N_RECORDS].numpy(), arrays["dense_i8"])
    got, expected = _answers(port, 300, top_k=5), _answers(jax_loaded, 300, top_k=5)
    assert any(got)
    assert [[i for i, _ in row] for row in got] == [[i for i, _ in row] for row in expected]
    for g_row, e_row in zip(got, expected):
        np.testing.assert_array_equal(
            np.array([s for _, s in g_row], np.float32), np.array([s for _, s in e_row], np.float32)
        )
    assert "r5" not in {i for row in got for i, _ in row}


def test_mesh_store_shards_keep_the_pitch():
    """On a 2-device mesh every shard of the dense and sketch matrices is a
    pitched view, and the section path answers as the unsharded store."""
    from verbatim_rag_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp=2, tp=1, devices=["cpu"] * 2)
    sharded = DeviceVectorStore(dense_dim=300, mesh=mesh, **{**STORE, "block": 2 * 8192})
    sharded.add_vectors(_records(300))
    sharded.flush()
    for name in ("_dense", "_sp_proj"):
        for shard in getattr(sharded, name).shards:
            assert ft.is_pitched(shard) and not shard.is_contiguous()
    assert getattr(sharded, "_dense").nbytes == 2 * 8192 * 304
    sharded.candidate_impl = "section"
    single = _port_store(300, block=2 * 8192)
    single.candidate_impl = "section"
    got, expected = _answers(sharded, 300), _answers(single, 300)
    assert any(got)
    assert [[i for i, _ in row] for row in got] == [[i for i, _ in row] for row in expected]
