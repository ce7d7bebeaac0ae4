"""The port's CUDA kernels and CUDA main path, on the card.

Every test here is marked ``cuda`` and skips without a GPU (a CUDA kernel has
no CPU mode). The file imports nothing of JAX, so it runs where the port
runs:

    python3 -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: section tables and bucket-max v2 on int8 rows bit-equal to their
plain versions (exact int32 sums, the same float operations); on bf16 rows
values within 2⁻¹⁵ of the dot's scale |q|·|c| (float32 sums in another
order) and rows equal except in buckets whose two best scores lie within
that. Flash attention float32 1e-5. bf16 holds each live attention
row (b, q, h) to its own scale: max|out − plain| over D within 2e-2 of
max|plain| plus half a bf16 ulp of that max (the plain version rounds the
probabilities to bf16 before P·V, the kernel rounds the unnormalised ones,
and the output is bf16). Rescore rtol 1e-5 (float32 sums over the m slots
in another order), missing candidates exactly −1e30.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from verbatim_rag_tpu_torch.ops import flash_attention as fa
from verbatim_rag_tpu_torch.ops import fused_topk as ft
from verbatim_rag_tpu_torch.ops import rescore as rs
from verbatim_rag_tpu_torch.ops import section as sec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(batch, seq, heads, head_dim, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, seq, heads, head_dim)).astype(np.float32) for _ in range(3)]


def _bf16_row_ratio(got, expected, live):
    """Worst live row (b, q, h): max|got − expected| over D divided by
    2e-2·max|expected| plus half a bf16 ulp of that max."""
    err = (got.float() - expected).abs().amax(dim=-1)
    scale = expected.abs().amax(dim=-1)
    _, exponent = torch.frexp(scale)
    limit = 2e-2 * scale + torch.ldexp(torch.ones_like(scale), exponent - 9)
    return float((err / limit)[live].max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 128, 7])
def test_flash_kernel_matches_plain(cuda, dtype, window):
    lengths = np.array([333, 0, 200, 17], np.int32)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(4, 333, 3, 64, 2))
    lens = torch.from_numpy(lengths).to(cuda)
    before = fa.launches
    got = fa.flash_attention(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    expected = fa.attention_reference(q, k, v, lens, window)
    live = torch.arange(333, device=cuda)[None, :] < lens[:, None]
    if dtype == torch.float32:
        torch.testing.assert_close(got[live], expected[live], rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_row_ratio(got, expected, live) <= 1.0
    assert (got[1] == 0).all()


def test_flash_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, torch.ones(1, dtype=torch.int32, device=cuda))


def _rescore_inputs(b, c, n, m, qm, seed):
    rng = np.random.default_rng(seed)
    sp_ids = rng.integers(0, 3 * max(m, qm), size=(n, m)).astype(np.int32)
    sp_w = rng.random((n, m), dtype=np.float32)
    q_ids = rng.integers(0, 3 * max(m, qm), size=(b, qm)).astype(np.int32)
    q_w = rng.random((b, qm), dtype=np.float32)
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    return cand, sp_ids, sp_w, q_ids, q_w


@pytest.mark.parametrize(
    "b,c,n,m,qm", [(4, 8, 64, 16, 8), (3, 7, 50, 5, 3), (5, 40, 500, 130, 1100), (64, 256, 5000, 128, 32)]
)
def test_rescore_kernel_matches_plain(cuda, b, c, n, m, qm):
    arrays = [torch.from_numpy(a).to(cuda) for a in _rescore_inputs(b, c, n, m, qm, seed=b)]
    before = rs.launches
    got = rs.exact_rescore_dispatch(*arrays)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    expected = rs.exact_rescore_oneshot(*arrays)
    miss = arrays[0] < 0
    assert (got[miss] == -1e30).all()
    torch.testing.assert_close(got[~miss], expected[~miss], rtol=1e-5, atol=1e-6)


def test_rescore_kernel_refuses_narrow_index_dtypes(cuda):
    arrays = [torch.from_numpy(a).to(cuda) for a in _rescore_inputs(2, 4, 10, 4, 2, seed=0)]
    arrays[1] = arrays[1].to(torch.int16)
    with pytest.raises(TypeError, match="int16"):
        rs.exact_rescore_dispatch(*arrays)


def test_store_on_cuda_matches_cpu(cuda):
    from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    texts = [f"doc {i} about solar wind storage grid {i % 5} {i % 7}" for i in range(300)]
    dense, sparse = HashedBowDenseProvider(64), HashedSparseProvider(4096)
    records = [
        {"id": str(i), "text": t, "dense": d, "sparse": s}
        for i, (t, d, s) in enumerate(zip(texts, dense.embed_batch(texts), sparse.embed_batch(texts)))
    ]
    queries = ["solar grid 3", "wind storage 6", "doc 17"]
    results = []
    for device in ("cpu", "cuda"):
        store = DeviceVectorStore(dense_dim=64, sparse_vocab=4096, sparse_max_nnz=16, device=device)
        store.add_vectors([dict(r) for r in records])
        before = rs.launches
        out = store.query_batch(
            dense_queries=dense.embed_batch(queries), sparse_queries=sparse.embed_batch(queries),
            top_k=5,
        )
        assert (rs.launches > before) == (device == "cuda")
        results.append([[h.id for h in row] for row in out])
    assert results[0] == results[1]


def test_extractor_on_cuda_matches_cpu(cuda):
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, demo_highlighter_config

    text = " ".join(["Solar panels convert sunlight into electricity."] * 60)
    probs = []
    for device in ("cpu", "cuda"):
        extractor = ModelSpanExtractor(config=demo_highlighter_config(), device=device, seed=1)
        plan = extractor._plan("how do solar panels work", text)
        ids = np.zeros((1, 512), np.int32)
        mask = np.zeros((1, 512), np.int32)
        ids[0, : len(plan["rows"][0])] = plan["rows"][0]
        mask[0, : len(plan["rows"][0])] = 1
        before = fa.launches
        probs.append(extractor._forward_probs(ids, mask))
        assert (fa.launches - before) == (4 if device == "cuda" else 0)
    np.testing.assert_allclose(probs[1], probs[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 20, 256])
def test_topk_tie_order_on_cuda(cuda, k):
    from verbatim_rag_tpu_torch.ops.dense import _topk_by_key, topk

    gen = torch.Generator(device=cuda).manual_seed(k)
    scores = torch.randint(-3, 4, (64, 5000), generator=gen, device=cuda).float()
    scores[1, 100:] = -1e30
    scores[2] = 0.25
    vals, pos = topk(scores, k)
    ref_vals, ref_pos = _topk_by_key(scores, k)
    assert torch.equal(pos, ref_pos) and torch.equal(vals, ref_vals)


def _rows_and_queries(n, dims, b, seed, dtype, device):
    """Per arm: unit-norm rows ([N, d] int8 codes + scales, or bf16) and
    float32 queries, made with numpy."""
    from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int8

    rng = np.random.default_rng(seed)
    arms = []
    for d in dims:
        c = rng.normal(size=(n, d)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(device)
        c = torch.from_numpy(c).to(device)
        if dtype == "int8":
            codes, scale = quantize_rows_int8(c)
            arms.append((codes, q, scale))
        else:
            arms.append((c.to(torch.bfloat16), q, None))
    return arms


def _test_mask(n, device):
    mask = torch.ones(n, dtype=torch.bool)
    mask[::7] = False
    mask[np.arange(n) % 128 == 5] = False  # a dead bucket in every block
    return mask.to(device)


def _assert_tables_match(got, expected, q, scores_fn, block, exact):
    """Tables as (values, rows) pairs: bit-equal for int8; bf16 within 2⁻¹⁵
    of |q| with rows equal except in buckets whose two best are that close."""
    (g_vals, g_rows), (e_vals, e_rows) = got, expected
    if exact:
        assert torch.equal(g_vals.view(torch.int32), e_vals.view(torch.int32))
        assert torch.equal(g_rows, e_rows)
        return
    live = e_vals > -1e29
    assert torch.equal(live, g_vals > -1e29)
    tol = 2.0**-15 * q.float().norm(dim=1, keepdim=True).expand_as(g_vals)
    assert bool(((g_vals - e_vals).abs() <= tol)[live].all())
    blocks = scores_fn().reshape(q.shape[0], -1, block // 128, 128)
    top2 = blocks.topk(2, dim=2).values if blocks.shape[2] > 1 else None
    near = torch.zeros_like(live) if top2 is None else (
        (top2[:, :, 0] - top2[:, :, 1]).reshape(q.shape[0], -1).abs() <= tol
    )
    assert bool(((g_rows == e_rows) | ~live | near).all())


def _decode(table, block):
    vals, pos = sec.unpack_table(table)
    cols = torch.arange(table.shape[1], device=table.device)
    return vals, (cols // 128) * block + pos * 128 + cols % 128


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize(
    "n,block,b,dims",
    [(1024, 256, 5, (64, 32)), (3 * 8192, 8192, 70, (384, 768)), (2 * 16384, 16384, 13, (48, 96))],
)
def test_section_kernel_matches_plain(cuda, n, block, b, dims, masked, dtype):
    arms = _rows_and_queries(n, dims, b, seed=n + b, dtype=dtype, device=cuda)
    corpora, queries, scales = zip(*arms)
    scales = scales if dtype == "int8" else ()
    mask = _test_mask(n, cuda) if masked else None
    before = sec.launches
    got = sec.section_bucket_tables(corpora, queries, mask, scales=scales, block_cols=block)
    torch.cuda.synchronize()
    assert sec.launches == before + 1
    expected = sec.section_tables_reference(
        corpora, queries, mask, scales or (None,) * len(arms), block
    )
    for a, (g, e) in enumerate(zip(got, expected)):
        assert g.shape == e.shape == (b, n // block * 128)
        c, q = corpora[a], queries[a]

        def scores(c=c, q=q):
            s = q.to(torch.bfloat16).float() @ c.float().T
            return s if mask is None else torch.where(mask, s, -1e30)

        _assert_tables_match(
            _decode(g, block), _decode(e, block), q, scores, block, exact=dtype == "int8"
        )


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("n,b,d", [(2048, 5, 64), (123 * 8192, 40, 384), (6 * 16384, 130, 768)])
def test_bucket_kernel_matches_plain(cuda, n, b, d, dtype):
    ((corpus, q, scale),) = _rows_and_queries(n, (d,), b, seed=d, dtype=dtype, device=cuda)
    mask = _test_mask(n, cuda)
    before = ft.launches
    got = ft.matmul_bucket_max_v2(corpus, q, mask, scale=scale)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    expected = ft.matmul_bucket_max_v2_reference(corpus, q, mask, scale)
    block = ft.choose_block_rows(n)

    def scores():
        return torch.where(mask, q.to(torch.bfloat16).float() @ corpus.float().T, -1e30)

    _assert_tables_match(got, expected, q, scores, block, exact=dtype == "int8")
    assert (got[0][:, 5] <= -1e29).all()


def test_table_kernels_refuse_float32_rows(cuda):
    rows, q = torch.zeros(256, 32, device=cuda), torch.zeros(2, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="float32"):
        sec.section_bucket_tables((rows,), (q,), None, block_cols=256)
    with pytest.raises(NotImplementedError, match="float32"):
        ft.matmul_bucket_max_v2(rows, q, torch.ones(256, dtype=torch.bool, device=cuda))


@pytest.mark.parametrize("impl", ["auto", "bucket"])
def test_int8_store_on_cuda_matches_cpu(cuda, impl):
    from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    texts = [f"doc {i} about solar wind storage grid {i % 5} {i % 7}" for i in range(300)]
    dense, sparse = HashedBowDenseProvider(64), HashedSparseProvider(4096)
    records = [
        {"id": str(i), "text": t, "dense": d, "sparse": s}
        for i, (t, d, s) in enumerate(zip(texts, dense.embed_batch(texts), sparse.embed_batch(texts)))
    ]
    queries = ["solar grid 3", "wind storage 6", "doc 17"]
    results = []
    for device in ("cpu", "cuda"):
        store = DeviceVectorStore(
            dense_dim=64, sparse_vocab=4096, sparse_max_nnz=16, device=device,
            dense_dtype="int8", sketch_dtype="int8", candidate_impl=impl,
        )
        store.add_vectors([dict(r) for r in records])
        counter = ft if impl == "bucket" else sec
        before = counter.launches
        out = store.query_batch(
            dense_queries=dense.embed_batch(queries), sparse_queries=sparse.embed_batch(queries),
            top_k=5, search_params={"rescore_depth": 64},
        )
        assert (counter.launches > before) == (device == "cuda")
        results.append([[h.id for h in row] for row in out])
    assert results[0] == results[1]
