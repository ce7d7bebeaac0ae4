"""Strided bucket-max (v2) in the PyTorch port vs the JAX package's kernel.

The same numpy inputs go through the JAX `matmul_bucket_max_v2` /
`fused_candidate_topk_v2` (the Pallas kernels in interpret mode, both
variants) and the port's plain version.

Tolerances:
- int8 corpora: values and rows bit-equal (exact int32 dots, the same float
  operations in the same order);
- bf16 corpora: float32 dots summed in another order, so values within 2⁻¹⁵
  of the dot's scale |q|·|c| and rows equal except in buckets whose two best
  scores lie within that;
- dispatch and fallbacks: equal (the block geometry is pinned in
  `test_torch_copies.py`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.ops import dense as jax_dense
from verbatim_rag_tpu.ops import fused_topk as jax_ft
from verbatim_rag_tpu_torch.ops import dense, fused_topk

BUCKET = 128


def _inputs(n, d, b, seed, dead_lane=None):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.normal(size=(b, d)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::7] = False
    if dead_lane is not None:
        mask[np.arange(n) % BUCKET == dead_lane] = False  # a dead bucket in every block
    return corpus, q, mask


@pytest.mark.parametrize("variant", ["onedot", "chunked"])
@pytest.mark.parametrize("n,b", [(2048, 5), (2048 * 3, 3)])
def test_int8_bit_equal(n, b, variant):
    corpus, q, mask = _inputs(n, 64, b, seed=n + b, dead_lane=5)
    codes, scale = jax_dense.quantize_rows_int8(corpus)
    e_vals, e_rows = jax_ft.matmul_bucket_max_v2(
        jnp.asarray(codes), jnp.asarray(q), jnp.asarray(mask), variant=variant, chunk_pos=4,
        interpret=True, scale=jnp.asarray(scale),
    )
    g_vals, g_rows = fused_topk.matmul_bucket_max_v2(
        torch.from_numpy(codes), torch.from_numpy(q), torch.from_numpy(mask),
        variant=variant, chunk_pos=4, scale=torch.from_numpy(scale),
    )
    np.testing.assert_array_equal(g_vals.numpy().view(np.int32), np.array(e_vals).view(np.int32))
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    assert (g_vals[:, 5] <= -1e29).all()  # the dead bucket
    assert g_rows.max() <= n - 1


def test_multi_block_and_negative_scores():
    n, d, b = 2048 * 17, 16, 3  # 17 blocks of 2048 rows
    corpus, q, mask = _inputs(n, d, b, seed=3)
    corpus, q = np.abs(corpus), -np.abs(q)  # every score below zero
    codes, scale = jax_dense.quantize_rows_int8(corpus)
    e_vals, e_rows = jax_ft.matmul_bucket_max_v2(
        jnp.asarray(codes), jnp.asarray(q), jnp.asarray(mask), interpret=True,
        scale=jnp.asarray(scale),
    )
    g_vals, g_rows = fused_topk.matmul_bucket_max_v2(
        torch.from_numpy(codes), torch.from_numpy(q), torch.from_numpy(mask),
        scale=torch.from_numpy(scale),
    )
    assert g_vals.shape == (b, 17 * BUCKET)
    np.testing.assert_array_equal(g_vals.numpy().view(np.int32), np.array(e_vals).view(np.int32))
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    assert (g_vals < 0).all()


@pytest.mark.parametrize("variant", ["onedot", "chunked"])
def test_bf16_matches(variant):
    n, d, b = 4096, 64, 4
    corpus, q, mask = _inputs(n, d, b, seed=11, dead_lane=9)
    e_vals, e_rows = jax_ft.matmul_bucket_max_v2(
        jnp.asarray(corpus, jnp.bfloat16), jnp.asarray(q), jnp.asarray(mask),
        variant=variant, chunk_pos=4, interpret=True,
    )
    g_vals, g_rows = fused_topk.matmul_bucket_max_v2(
        torch.from_numpy(corpus).to(torch.bfloat16), torch.from_numpy(q),
        torch.from_numpy(mask), variant=variant, chunk_pos=4,
    )
    e_vals, e_rows = torch.from_numpy(np.array(e_vals)), torch.from_numpy(np.array(e_rows))
    live = e_vals > -1e29
    assert torch.equal(live, g_vals > -1e29)
    qb = torch.from_numpy(q).to(torch.bfloat16).float()
    tol = 2.0**-15 * qb.norm(dim=1, keepdim=True).expand_as(g_vals)
    assert bool(((g_vals - e_vals).abs() <= tol)[live].all())
    c = torch.from_numpy(corpus).to(torch.bfloat16).float()
    scores = torch.where(torch.from_numpy(mask), qb @ c.T, -1e30)
    top2 = scores.reshape(b, -1, BUCKET).topk(2, dim=1).values  # one block
    near = (top2[:, 0] - top2[:, 1]).abs() <= tol
    assert bool(((g_rows == e_rows) | ~live | near).all())


@pytest.mark.parametrize("k", [1, 8, 128])
def test_fused_candidate_topk_v2_matches(k):
    corpus, q, mask = _inputs(2048, 32, 3, seed=k)
    codes, scale = jax_dense.quantize_rows_int8(corpus)
    e_vals, e_rows = jax_ft.fused_candidate_topk_v2(
        jnp.asarray(codes), jnp.asarray(q), k, jnp.asarray(mask), interpret=True,
        scale=jnp.asarray(scale),
    )
    g_vals, g_rows = fused_topk.fused_candidate_topk_v2(
        torch.from_numpy(codes), torch.from_numpy(q), k, torch.from_numpy(mask),
        scale=torch.from_numpy(scale),
    )
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    np.testing.assert_array_equal(g_vals.numpy(), np.asarray(e_vals))


@pytest.mark.parametrize(
    "n,k,exact", [(1024, 8, False), (1024, 200, False), (960, 8, False), (1024, 8, True)]
)
def test_candidate_topk_bucket_dispatch(n, k, exact):
    """impl="bucket" serves from the bucket table, falls back to the score
    matrix when k exceeds the table width or the geometry does not tile,
    and never serves an exact-selection request."""
    corpus, q, mask = _inputs(n, 32, 2, seed=n + k)
    codes, scale = jax_dense.quantize_rows_int8(corpus)
    e_vals, e_rows = jax_dense.candidate_topk(
        jnp.asarray(codes), jnp.asarray(q), k, jnp.asarray(mask), jnp.asarray(scale),
        exact_topk=exact, impl="bucket", interpret=True,
    )
    g_vals, g_rows = dense.candidate_topk(
        torch.from_numpy(codes), torch.from_numpy(q), k, torch.from_numpy(mask),
        torch.from_numpy(scale), exact_topk=exact, impl="bucket",
    )
    served = dense.bucket_kernel_supported(torch.from_numpy(codes), scale, k) and not exact
    assert served == (n == 1024 and k == 8 and not exact)
    np.testing.assert_array_equal(g_rows.numpy(), np.asarray(e_rows))
    np.testing.assert_array_equal(g_vals.numpy(), np.asarray(e_vals))


def test_bucket_support_and_validation():
    codes = torch.zeros(2048, 16, dtype=torch.int8)
    assert not dense.bucket_kernel_supported(codes, None)
    assert dense.bucket_kernel_supported(codes, torch.ones(2048, 1), 128)
    assert not dense.bucket_kernel_supported(codes, torch.ones(2048, 1), 129)
    q, mask = torch.zeros(2, 16), torch.ones(2048, dtype=torch.bool)
    with pytest.raises(ValueError, match="requires scale"):
        fused_topk.matmul_bucket_max_v2(codes, q, mask)
    with pytest.raises(ValueError, match="chunk_pos"):
        fused_topk.matmul_bucket_max_v2(codes, q, mask, variant="chunked", chunk_pos=3, scale=torch.ones(2048, 1))
    with pytest.raises(ValueError, match="variant"):
        fused_topk.matmul_bucket_max_v2(codes, q, mask, variant="other", scale=torch.ones(2048, 1))
    with pytest.raises(ValueError, match="corpus rows"):
        fused_topk.matmul_bucket_max_v2(torch.zeros(960, 16), q, torch.ones(960, dtype=torch.bool))


def cta_smem(dtype, row_bytes: int, mode: str = "v2") -> int:
    """Shared memory of one CTA by the Python mirrors of `csrc/section.cu`:
    the FMA walk's one size a mode for float32 rows (`_FMA_SMEM`), else the
    wgmma walk's tile and ring at `walk_geometry`'s (`_walk_smem`)."""
    if dtype == torch.float32:
        return fused_topk._FMA_SMEM[mode]
    queries, stages = fused_topk.walk_geometry(row_bytes, mode)
    return fused_topk._walk_smem(queries, row_bytes, stages, mode)


@pytest.mark.parametrize(
    "dtype,d,mode,row_bytes",
    [
        (torch.float32, 384, "section", 1536),  # the dense arm
        (torch.float32, 768, "section", 3072),  # the sketch arm
        (torch.float32, 768, "v1", 3072),
        (torch.float32, 1376, "section", 5504),  # the widest float32 row
        (torch.bfloat16, 1472, "v1", 2944),  # the widest bf16 / int8 row
        (torch.int8, 2944, "section", 2944),
    ],
)
def test_kernel_rows_accepted(dtype, d, mode, row_bytes):
    """The shape and shared-memory rule of `csrc/section.cu`: float32 rows
    take the FMA walk's 128-query tile, whose queries stream beside the rows
    (4 stages of 32 KB and 64 KB of running maxima: 197,696 bytes of the
    232,448 at any width); int8 and bf16 rows take the wgmma walk's tile (64
    queries at 2944 bytes)."""
    corpus = torch.zeros(4, d, dtype=dtype)
    assert fused_topk.check_kernel_rows(corpus, "bucket", mode) == row_bytes
    assert cta_smem(dtype, row_bytes, mode) <= 232448
    assert fused_topk.tile_queries(dtype, row_bytes, mode) == (128 if dtype == torch.float32 else 64)


def test_kernel_rows_refused():
    # The FMA walk: 4 stages of rows and queries, the running maxima (not
    # for v1), 8 mbarriers and 1024 bytes of slack, whatever the row width.
    assert cta_smem(torch.float32, 3072) == 4 * 32768 + 65536 + 64 + 1024
    assert cta_smem(torch.float32, 16, "v1") == 4 * 32768 + 64 + 1024
    wide = torch.zeros(4, 1380)  # 5520 bytes: past the old 32-query tile, taken now
    assert fused_topk.check_kernel_rows(wide, "bucket", "section") == 5520
    # v1 on bf16 d = 768: 64 queries × 12 chunks, 7 stages, 4 side slots of 640 bytes.
    assert cta_smem(torch.bfloat16, 1536, "v1") == (
        12 * 64 * 128 + 7 * 16384 + 4 * 640 + (1 + 14 + 8) * 8 + 1024
    )
    for dtype, d in ((torch.float32, 1381), (torch.float32, 6), (torch.bfloat16, 1484), (torch.int8, 2968 + 1)):
        with pytest.raises(ValueError, match="16-byte multiple"):
            fused_topk.check_kernel_rows(torch.zeros(4, d, dtype=dtype), "bucket")
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32 rows"):
            fused_topk.check_kernel_rows(torch.zeros(4, 64, dtype=dtype), "bucket")


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [384, 768, 1024])
def test_v2_kernel_geometry(dtype, d):
    """v2's CTA fits shared memory at the repo's widths and one beyond: int8
    and bf16 rows on the wgmma walk (128 queries while their tile fits beside
    a 4-deep ring, else 64 walked by one warpgroup, a ring of 4-8 stages),
    float32 rows on the FMA walk's 128-query tile."""
    row_bytes = d * torch.tensor([], dtype=dtype).element_size()
    smem = cta_smem(dtype, row_bytes, "v2")
    assert smem <= 232448
    assert fused_topk.check_kernel_rows(torch.zeros(4, d, dtype=dtype), "bucket", "v2") == row_bytes
    queries = fused_topk.tile_queries(dtype, row_bytes, "v2")
    if dtype == torch.float32:
        assert queries == 128 and smem == cta_smem(dtype, row_bytes, "section")
        assert fused_topk.table_geometry(dtype, row_bytes, "v2") == (128, 0)
        return
    chunks = -(-row_bytes // 128)
    got_queries, stages = fused_topk.walk_geometry(row_bytes, "v2")
    assert queries == got_queries == (128 if row_bytes <= 1152 else 64)
    assert 4 <= stages <= 8
    assert smem == chunks * queries * 128 + stages * 16384 + 4 * 640 + (9 + 2 * stages) * 8 + 1024
    assert fused_topk._walk_smem(queries, row_bytes, stages + 1, "v2") > 232448 or stages == 8


def test_v2_kernel_geometry_edges():
    """The widest rows each tile takes, and the widest row that keeps its
    query tile resident (2944 bytes, 64 queries and two stages); one chunk
    more streams the tile through a 6-stage ring of 128 queries, the same
    for section, v2 and v1."""
    for mode in ("section", "v2", "v1"):
        assert fused_topk.walk_geometry(1152, mode)[0] == 128
        assert fused_topk.walk_geometry(1168, mode)[0] == 64
        assert fused_topk.walk_geometry(2944, mode) == (64, 2)
        assert not fused_topk.walk_streams(2944) and fused_topk.walk_streams(2960)
        assert fused_topk.walk_geometry(2960, mode) == (128, 6)
        wide = torch.zeros(4, 1472, dtype=torch.bfloat16)  # 2944 bytes
        assert fused_topk.check_kernel_rows(wide, "bucket", mode) == 2944
        wider = torch.zeros(4, 1480, dtype=torch.bfloat16)  # 2960 bytes: streamed
        assert fused_topk.check_kernel_rows(wider, "bucket", mode) == 2960


@pytest.mark.parametrize(
    "dtype,d,mode",
    [
        (torch.int8, 3072, "section"),  # text-embedding-3-large
        (torch.int8, 3072, "v2"),
        (torch.int8, 4096, "section"),
        (torch.int8, 4096, "v2"),
        (torch.bfloat16, 1536, "section"),  # text-embedding-ada-002
        (torch.bfloat16, 1536, "v2"),
        (torch.bfloat16, 1536, "v1"),
        (torch.bfloat16, 4096, "v1"),
    ],
)
def test_wide_rows_stream_the_query_tile(dtype, d, mode):
    """Rows past 2944 bytes, which the wgmma walk refused while its query
    tile had to stay resident, are taken: the tile streams through the ring
    beside the rows, 32 KB a stage (128 rows and 128 queries × 128 bytes),
    6 stages, within shared memory. The mirror's resident limit is the
    kernel source's `kWalkResidentChunks`."""
    import re
    from pathlib import Path

    source = (Path(fused_topk.__file__).parent.parent / "csrc" / "section.cu").read_text()
    resident = int(re.search(r"constexpr int kWalkResidentChunks = (\d+);", source).group(1))
    assert resident == fused_topk._WALK_RESIDENT_CHUNKS == 2944 // 128
    row_bytes = d * torch.tensor([], dtype=dtype).element_size()
    assert fused_topk.check_kernel_rows(torch.zeros(4, d, dtype=dtype), "bucket", mode) == row_bytes
    assert fused_topk.walk_streams(row_bytes)
    assert fused_topk.walk_geometry(row_bytes, mode) == (128, 6)
    side = 4 * fused_topk._WALK_SIDE_BYTES[mode]
    smem = cta_smem(dtype, row_bytes, mode)
    assert smem == 6 * (16384 + 128 * 128) + side + (1 + 12 + 8) * 8 + 1024 <= fused_topk._SMEM_LIMIT
    assert fused_topk._walk_smem(128, row_bytes, 7, mode) > fused_topk._SMEM_LIMIT


def test_walk_side_slot_bytes_match_the_kernel_source():
    """The Python mirror of the wgmma walk's shared memory counts the side
    slots as `csrc/section.cu` lays them out: c_scale and the mask bytes for
    v2 and v1 (`kSideBytesV2`), c_scale and mask_add as float32 for section
    (`kSideBytesSection`); so section's ring is shallower where they differ."""
    import re
    from pathlib import Path

    source = (Path(fused_topk.__file__).parent.parent / "csrc" / "section.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kSideBytes\w+) = (\d+);", source))
    assert int(consts["kSideBytesV2"]) == fused_topk._WALK_SIDE_BYTES["v2"] == 640
    assert int(consts["kSideBytesSection"]) == fused_topk._WALK_SIDE_BYTES["section"] == 1024
    assert fused_topk._WALK_SIDE_BYTES["v1"] == fused_topk._WALK_SIDE_BYTES["v2"]
    assert fused_topk._walk_smem(64, 1536, 7, "section") - fused_topk._walk_smem(64, 1536, 7, "v2") == 4 * 384


@pytest.mark.parametrize("mode", ["section", "v2", "v1"])
def test_fma_walk_geometry_matches_the_kernel_source(mode):
    """The Python mirror of the float32 walk's shared memory and tile
    (`fma_smem_bytes`, `kFmaQueries`, `kFmaStages` in `csrc/section.cu`):
    128 queries, a ring of 4 stages of 32 KB (rows and queries), the running
    maxima for section and v2; one size a mode, whatever the row width."""
    import re
    from pathlib import Path

    source = (Path(fused_topk.__file__).parent.parent / "csrc" / "section.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kFma\w+) = ([^;]+);", source))
    assert int(consts["kFmaQueries"]) == fused_topk.FMA_QUERIES == 128
    assert int(consts["kFmaStages"]) == 4
    assert consts["kFmaHalfStage"] == "128 * kChunk" and consts["kFmaStageBytes"] == "2 * kFmaHalfStage"
    assert consts["kFmaBestBytes"] == "kFmaQueries * kLanes * 4"
    best = 0 if mode == "v1" else 65536
    assert fused_topk._FMA_SMEM[mode] == 4 * 32768 + best + 2 * 4 * 8 + 1024 <= 232448
    for d in (4, 384, 768, 4096):
        assert fused_topk.table_geometry(torch.float32, 4 * d, mode) == (128, 0)
        assert cta_smem(torch.float32, 4 * d, mode) == fused_topk._FMA_SMEM[mode]
    assert fused_topk.table_geometry(torch.bfloat16, 768, mode) == fused_topk.walk_geometry(768, mode)


@pytest.mark.parametrize("x", ["rows", "queries"])
def test_quantize_int8_bit_equal(x):
    """Stored rows are quantized as the JAX store does (numpy, a true
    division by 127); queries as the JAX package's compiled programs do."""
    import jax

    rng = np.random.default_rng(0)
    data = rng.normal(size=(300, 48)).astype(np.float32) * rng.random((300, 1)).astype(np.float32)
    data[3] = 0.0  # scale clipped at 1e-12
    data[4, :5] = [0.5, -0.5, 1.5, 2.5, 127.0]  # halves round to even
    if x == "rows":
        e_codes, e_scale = jax_dense.quantize_rows_int8(data)
        g_codes, g_scale = dense.quantize_rows_int8(torch.from_numpy(data))
    else:
        e_codes, e_scale = jax.jit(jax_dense.quantize_rows_int8)(jnp.asarray(data))
        g_codes, g_scale = dense.quantize_queries_int8(torch.from_numpy(data))
    np.testing.assert_array_equal(g_codes.numpy(), np.asarray(e_codes))
    np.testing.assert_array_equal(g_scale.numpy().view(np.int32), np.array(e_scale).view(np.int32))


def test_int8_dense_scores_bit_equal():
    corpus, q, _ = _inputs(512, 96, 7, seed=1)
    codes, scale = jax_dense.quantize_rows_int8(corpus)
    expected = jax_dense.dense_scores(jnp.asarray(codes), jnp.asarray(q), jnp.asarray(scale))
    got = dense.dense_scores(torch.from_numpy(codes), torch.from_numpy(q), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.array(expected).view(np.int32))
