"""The row-sharded searches of the PyTorch port vs the JAX package's.

The JAX side runs its ``shard_map`` programs on its 8 virtual CPU devices
(``make_mesh(dp=4, tp=2)``), the port on ``make_mesh(dp=4, tp=2,
devices=["cpu"] * 8)``; inputs come from a seed with numpy. Each of the five
sharded functions is held to its JAX counterpart and to the port's own
single-device op on the whole corpus.

Tolerances: rows equal; scores at rtol / atol 5e-4 (the JAX side's float32
dots are summed in another order). JAX selects exactly here
(``exact_topk=True``, ``table_select="exact"``), as the port always does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from verbatim_rag_tpu.ops.dense import Int4Rows as JaxInt4Rows
from verbatim_rag_tpu.ops.dense import quantize_rows_int8 as jax_quantize_int8
from verbatim_rag_tpu.parallel import sharded_search as jss
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu_torch.ops.dense import (
    Int4Rows,
    candidate_topk,
    quantize_rows_int4,
    quantize_rows_int8,
)
from verbatim_rag_tpu_torch.parallel import RowSharded, make_mesh, replicated, row_sharding
from verbatim_rag_tpu_torch.parallel import sharded_search as ss

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

RTOL = ATOL = 5e-4


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(dp=4, tp=2), make_mesh(dp=4, tp=2, devices=["cpu"] * 8)


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _data(n=1024, d=32, dp=64, m=8, b=4, qm=4, seed=11):
    rng = np.random.default_rng(seed)
    mask = np.ones(n, bool)
    mask[::13] = False
    return dict(
        dense=_unit(rng, (n, d)),
        sketch=rng.normal(size=(n, dp)).astype(np.float32),
        sp_ids=rng.integers(1, 500, size=(n, m)).astype(np.int32),
        sp_w=rng.random(size=(n, m)).astype(np.float32),
        dq=_unit(rng, (b, d)),
        sq=rng.normal(size=(b, dp)).astype(np.float32),
        q_ids=rng.integers(1, 500, size=(b, qm)).astype(np.int32),
        q_w=rng.random(size=(b, qm)).astype(np.float32),
        mask=mask,
    )


def _j(x, mesh):
    return jss.shard_rows(jnp.asarray(x), mesh)


def _jr(x, mesh):
    return jss.replicate(jnp.asarray(x), mesh)


def _t(x, mesh):
    return row_sharding(torch.from_numpy(np.asarray(x)), mesh)


def _r(x):
    return torch.from_numpy(np.asarray(x))


def _assert_pairs(got, want, rows_only=False):
    g_s, g_r = (np.asarray(t) for t in got)
    w_s, w_r = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(g_r, w_r)
    if not rows_only:
        np.testing.assert_allclose(g_s, w_s, rtol=RTOL, atol=ATOL)


# -- placement -----------------------------------------------------------------------------


def test_mesh_size_and_dp_major_order():
    mesh = make_mesh(dp=4, tp=2, devices=[f"cpu:{i}" for i in range(8)])
    assert mesh.size == 8
    assert [d.index for d in mesh.flat_devices] == list(range(8))
    assert mesh.devices[1][0].index == 2  # dp_i * tp + tp_i


def test_row_sharding_places_rows_in_shard_order(meshes):
    jax_mesh, mesh = meshes
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    placed = row_sharding(torch.from_numpy(x), mesh)
    assert placed.shape == (64, 3) and len(placed.shards) == 8 and placed.rows_per_shard == 8
    for i, shard in enumerate(placed.shards):
        np.testing.assert_array_equal(shard.numpy(), x[i * 8 : (i + 1) * 8])
    # JAX lays shard i on device i of the mesh's flattened ("dp", "tp") axis.
    jax_placed = _j(x, jax_mesh)
    devices = list(jax_mesh.devices.reshape(-1))
    for shard in jax_placed.addressable_shards:
        i = devices.index(shard.device)
        np.testing.assert_array_equal(np.asarray(shard.data), placed.shards[i].numpy())
    np.testing.assert_array_equal(placed[5:37].numpy(), x[5:37])
    with pytest.raises(ValueError, match="shard evenly"):
        row_sharding(torch.zeros(60, 3), mesh)


def test_row_sharded_writes_span_shards():
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    placed = row_sharding(torch.zeros(16, 2), mesh)
    placed[3:11] = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    placed[torch.tensor([0, 15, 8])] = torch.tensor([[-1.0, -1.0], [-2.0, -2.0], [-3.0, -3.0]])
    want = torch.zeros(16, 2)
    want[3:11] = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    want[torch.tensor([0, 15, 8])] = torch.tensor([[-1.0, -1.0], [-2.0, -2.0], [-3.0, -3.0]])
    torch.testing.assert_close(placed[:16], want)
    flags = row_sharding(torch.ones(16, dtype=torch.bool), mesh)
    flags[[2, 5, 13]] = False
    assert flags[:16].nonzero().flatten().tolist() == [i for i in range(16) if i not in (2, 5, 13)]
    doubled = flags.map(lambda f: f.long() * 2)
    assert isinstance(doubled, RowSharded) and doubled[:16].sum().item() == 26
    copies = replicated(torch.ones(3), mesh)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)


# -- sharded_dense_topk ---------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_sharded_dense_matches_jax(meshes, tier, k):
    jax_mesh, mesh = meshes
    data = _data(seed=k)
    dense, mask, dq = data["dense"], data["mask"], data["dq"]
    j_scale = t_scale = None
    if tier == "int8":
        codes, scale = jax_quantize_int8(dense)
        j_corpus, j_scale = _j(codes, jax_mesh), _j(scale, jax_mesh)
        t_corpus, t_scale = _t(codes, mesh), _t(scale, mesh)
    elif tier == "int4":
        rows = quantize_rows_int4(dense)
        j_corpus = JaxInt4Rows(_j(rows.packed, jax_mesh), _j(rows.scale, jax_mesh))
        t_corpus = Int4Rows(_t(rows.packed, mesh), _t(rows.scale, mesh))
    elif tier == "bfloat16":
        j_corpus = _j(jnp.asarray(dense, jnp.bfloat16), jax_mesh)
        t_corpus = row_sharding(torch.from_numpy(dense).to(torch.bfloat16), mesh)
    else:
        j_corpus, t_corpus = _j(dense, jax_mesh), _t(dense, mesh)
    want = jss.sharded_dense_topk(
        j_corpus, _jr(dq, jax_mesh), k, _j(mask, jax_mesh), jax_mesh, corpus_scale=j_scale
    )
    got = ss.sharded_dense_topk(t_corpus, _r(dq), k, _t(mask, mesh), mesh, corpus_scale=t_scale)
    _assert_pairs(got, want)
    # The port's single-device selection over the whole corpus.
    whole = Int4Rows(_r(rows.packed), _r(rows.scale)) if tier == "int4" else (
        t_corpus[: t_corpus.shape[0]]
    )
    single = candidate_topk(
        whole, _r(dq), k, _r(mask), None if t_scale is None else t_scale[: t_scale.shape[0]]
    )
    _assert_pairs(got, single)


# -- sharded_projected_sparse_topk -------------------------------------------------------------


@pytest.mark.parametrize("sketch_tier", ["float32", "int8"])
@pytest.mark.parametrize("rescore_impl", ["scan", "oneshot", "pallas"])
@pytest.mark.parametrize("k,depth", [(8, 32), (20, 64)])
def test_sharded_projected_sparse_matches_jax(meshes, sketch_tier, rescore_impl, k, depth):
    from verbatim_rag_tpu_torch.ops.hybrid import projected_sparse_topk

    jax_mesh, mesh = meshes
    data = _data(seed=depth)
    sketch = data["sketch"]
    j_scale = t_scale = None
    if sketch_tier == "int8":
        codes, scale = jax_quantize_int8(sketch)
        j_sketch, j_scale = _j(codes, jax_mesh), _j(scale, jax_mesh)
        t_sketch, t_scale = _t(codes, mesh), _t(scale, mesh)
    else:
        j_sketch, t_sketch = _j(sketch, jax_mesh), _t(sketch, mesh)
    want = jss.sharded_projected_sparse_topk(
        j_sketch, _j(data["sp_ids"], jax_mesh), _j(data["sp_w"], jax_mesh),
        _jr(data["sq"], jax_mesh), _jr(data["q_ids"], jax_mesh), _jr(data["q_w"], jax_mesh),
        k, depth, _j(data["mask"], jax_mesh), jax_mesh, sketch_scale=j_scale, rescore_impl="scan",
    )
    got = ss.sharded_projected_sparse_topk(
        t_sketch, _t(data["sp_ids"], mesh), _t(data["sp_w"], mesh),
        _r(data["sq"]), _r(data["q_ids"]), _r(data["q_w"]),
        k, depth, _t(data["mask"], mesh), mesh, sketch_scale=t_scale, rescore_impl=rescore_impl,
    )
    _assert_pairs(got, want)
    # Depth per shard covers each shard's live rows → the single-device op at
    # full depth finds the same exact top-k.
    full = ss.sharded_projected_sparse_topk(
        t_sketch, _t(data["sp_ids"], mesh), _t(data["sp_w"], mesh),
        _r(data["sq"]), _r(data["q_ids"]), _r(data["q_w"]),
        k, 128, _t(data["mask"], mesh), mesh, sketch_scale=t_scale, rescore_impl=rescore_impl,
    )
    single = projected_sparse_topk(
        t_sketch[:1024], _r(data["sp_ids"]), _r(data["sp_w"]), _r(data["sq"]),
        _r(data["q_ids"]), _r(data["q_w"]), k, 1024, _r(data["mask"]),
        sketch_scale=None if t_scale is None else t_scale[:1024], rescore_impl=rescore_impl,
    )
    _assert_pairs(full, single)


# -- sharded_hybrid_topk -------------------------------------------------------------------


def _ft_data(n=1024, dp=64, fm=8, b=4, fqm=4, seed=12):
    rng = np.random.default_rng(seed)
    return dict(
        ft_sketch=rng.normal(size=(n, dp)).astype(np.float32),
        ft_ids=rng.integers(1, 300, size=(n, fm)).astype(np.int32),
        ft_w=rng.random(size=(n, fm)).astype(np.float32),
        ft_qproj=rng.normal(size=(b, dp)).astype(np.float32),
        ft_qids=rng.integers(1, 300, size=(b, fqm)).astype(np.int32),
        ft_qw=rng.random(size=(b, fqm)).astype(np.float32),
    )


@pytest.mark.parametrize("three_way", [False, True], ids=["2way", "3way"])
@pytest.mark.parametrize("tier", ["float32", "int8"])
@pytest.mark.parametrize("k,fetch_k,depth", [(5, 10, 32), (10, 20, 64)])
def test_sharded_hybrid_matches_jax(meshes, three_way, tier, k, fetch_k, depth):
    from verbatim_rag_tpu_torch.ops.hybrid import hybrid_fused_topk, hybrid_fused_topk_3way

    jax_mesh, mesh = meshes
    data = _data(seed=fetch_k)
    ft = _ft_data()
    j_args, t_args, scales = {}, {}, {}
    for name in ("dense", "sketch", "ft_sketch"):
        x = data.get(name, ft.get(name))
        if tier == "int8":
            codes, scale = jax_quantize_int8(x)
            j_args[name], t_args[name] = _j(codes, jax_mesh), _t(codes, mesh)
            scales[name] = (_j(scale, jax_mesh), _t(scale, mesh))
        else:
            j_args[name], t_args[name] = _j(x, jax_mesh), _t(x, mesh)
            scales[name] = (None, None)
    weights = dict(dense_weight=0.4, sparse_weight=0.35)
    j_ft = t_ft = None
    if three_way:
        j_ft = (
            j_args["ft_sketch"], _j(ft["ft_ids"], jax_mesh), _j(ft["ft_w"], jax_mesh),
            _jr(ft["ft_qproj"], jax_mesh), _jr(ft["ft_qids"], jax_mesh), _jr(ft["ft_qw"], jax_mesh),
            0.25, scales["ft_sketch"][0],
        )
        t_ft = (
            t_args["ft_sketch"], _t(ft["ft_ids"], mesh), _t(ft["ft_w"], mesh),
            _r(ft["ft_qproj"]), _r(ft["ft_qids"]), _r(ft["ft_qw"]), 0.25, scales["ft_sketch"][1],
        )
    want = jss.sharded_hybrid_topk(
        j_args["dense"], j_args["sketch"], _j(data["sp_ids"], jax_mesh), _j(data["sp_w"], jax_mesh),
        _jr(data["dq"], jax_mesh), _jr(data["sq"], jax_mesh), _jr(data["q_ids"], jax_mesh),
        _jr(data["q_w"], jax_mesh), k=k, fetch_k=fetch_k, depth=depth,
        mask=_j(data["mask"], jax_mesh), mesh=jax_mesh, dense_scale=scales["dense"][0],
        sketch_scale=scales["sketch"][0], ft_arm=j_ft, **weights,
    )
    got = ss.sharded_hybrid_topk(
        t_args["dense"], t_args["sketch"], _t(data["sp_ids"], mesh), _t(data["sp_w"], mesh),
        _r(data["dq"]), _r(data["sq"]), _r(data["q_ids"]), _r(data["q_w"]),
        k=k, fetch_k=fetch_k, depth=depth, mask=_t(data["mask"], mesh), mesh=mesh,
        dense_scale=scales["dense"][1], sketch_scale=scales["sketch"][1],
        rescore_impl="pallas", ft_arm=t_ft, **weights,
    )
    _assert_pairs(got, want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # RRF is exact
    # At full depth every shard rescores all its live rows: the single-device
    # program at full depth ranks the same rows.
    full = dict(k=k, fetch_k=fetch_k, depth=1024, mask=_r(data["mask"]), **weights)
    whole = {name: t[:1024] for name, t in t_args.items()}
    s_whole = {name: None if t is None else t[:1024] for name, (_, t) in scales.items()}
    common = (whole["dense"], whole["sketch"], _r(data["sp_ids"]), _r(data["sp_w"]))
    queries = (_r(data["dq"]), _r(data["sq"]), _r(data["q_ids"]), _r(data["q_w"]))
    if three_way:
        single = hybrid_fused_topk_3way(
            *common, whole["ft_sketch"], _r(ft["ft_ids"]), _r(ft["ft_w"]), *queries,
            _r(ft["ft_qproj"]), _r(ft["ft_qids"]), _r(ft["ft_qw"]), ft_weight=0.25,
            dense_scale=s_whole["dense"], sketch_scale=s_whole["sketch"],
            ft_scale=s_whole["ft_sketch"], **full,
        )
    else:
        single = hybrid_fused_topk(
            *common, *queries, dense_scale=s_whole["dense"], sketch_scale=s_whole["sketch"], **full
        )
    sharded_full = ss.sharded_hybrid_topk(
        t_args["dense"], t_args["sketch"], _t(data["sp_ids"], mesh), _t(data["sp_w"], mesh),
        *queries, k=k, fetch_k=fetch_k, depth=1024, mask=_t(data["mask"], mesh), mesh=mesh,
        dense_scale=scales["dense"][1], sketch_scale=scales["sketch"][1], ft_arm=t_ft, **weights,
    )
    _assert_pairs(sharded_full, single)


def test_sharded_hybrid_bucket_runs_per_shard(monkeypatch):
    """candidate_impl="bucket" per shard: each 16384-row shard's table keeps
    one winner per lane, so with only the first 128 rows of each shard live
    every winner is a live row's own score and the bucket selection is the
    exact one. At a depth of each shard's 128 live rows that gives the rows
    of the single-device "xla" program at a depth of all 256 live rows, with
    the bucket path entered once per shard and arm."""
    from verbatim_rag_tpu_torch.ops import fused_topk
    from verbatim_rag_tpu_torch.ops.hybrid import hybrid_fused_topk

    calls = []
    plain = fused_topk.matmul_bucket_max_v2_reference

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return plain(*args, **kwargs)

    monkeypatch.setattr(fused_topk, "matmul_bucket_max_v2_reference", spy)
    mesh = make_mesh(dp=2, devices=["cpu"] * 2)
    data = _data(n=32768, d=16, dp=32, seed=3)
    mask = (np.arange(32768) % 16384) < 128
    codes, scale = quantize_rows_int8(torch.from_numpy(data["dense"]))
    s_codes, s_scale = quantize_rows_int8(torch.from_numpy(data["sketch"]))
    queries = (_r(data["dq"]), _r(data["sq"]), _r(data["q_ids"]), _r(data["q_w"]))
    kwargs = dict(k=8, fetch_k=16, depth=128, exact_topk=False)
    got = ss.sharded_hybrid_topk(
        row_sharding(codes, mesh), row_sharding(s_codes, mesh), _t(data["sp_ids"], mesh),
        _t(data["sp_w"], mesh), *queries, mask=_t(mask, mesh), mesh=mesh,
        dense_scale=row_sharding(scale, mesh), sketch_scale=row_sharding(s_scale, mesh),
        candidate_impl="bucket", **kwargs,
    )
    assert calls == [16384] * 4
    single = hybrid_fused_topk(
        codes, s_codes, _r(data["sp_ids"]), _r(data["sp_w"]), *queries, mask=_r(mask),
        dense_scale=scale, sketch_scale=s_scale, candidate_impl="xla", **dict(kwargs, depth=256),
    )
    _assert_pairs(got, single)


# -- sharded_hybrid_section_topk ------------------------------------------------------------


def _col(x, mesh):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, ("dp", "tp"))))


@pytest.mark.parametrize("three_way", [False, True], ids=["2way", "3way"])
@pytest.mark.parametrize("tier", ["float32", "int8"])
def test_sharded_section_matches_jax(meshes, monkeypatch, three_way, tier):
    """The JAX program in interpret mode over column-sharded transposes, the
    port over row-sharded rows; 256-row blocks (two a shard), depth below the
    table's width."""
    from verbatim_rag_tpu_torch.ops.section import hybrid_section_topk, hybrid_section_topk_3way

    jax_mesh, mesh = meshes
    data, ft = _data(n=4096), _ft_data(n=4096)
    bc, k, fetch_k, depth = 256, 6, 16, 96
    names = ["dense", "sketch"] + (["ft_sketch"] if three_way else [])
    j_t, t_rows, scales, whole, s_whole = {}, {}, {}, {}, {}
    for name in names:
        x = data.get(name, ft.get(name))
        if tier == "int8":
            codes, scale = jax_quantize_int8(x)
            x = np.asarray(codes)
            scales[name] = (_j(scale, jax_mesh), _t(scale, mesh))
            s_whole[name] = _r(scale)
        else:
            scales[name] = (None, None)
            s_whole[name] = None
        j_t[name], t_rows[name], whole[name] = _col(x.T, jax_mesh), _t(x, mesh), _r(x)
    j_ft = t_ft = None
    if three_way:
        j_ft = (
            j_t["ft_sketch"], _j(ft["ft_ids"], jax_mesh), _j(ft["ft_w"], jax_mesh),
            _jr(ft["ft_qproj"], jax_mesh), _jr(ft["ft_qids"], jax_mesh), _jr(ft["ft_qw"], jax_mesh),
            1.0, scales["ft_sketch"][0],
        )
        t_ft = (
            t_rows["ft_sketch"], _t(ft["ft_ids"], mesh), _t(ft["ft_w"], mesh),
            _r(ft["ft_qproj"]), _r(ft["ft_qids"]), _r(ft["ft_qw"]), 1.0, scales["ft_sketch"][1],
        )
    common = dict(k=k, fetch_k=fetch_k, depth=depth, dense_weight=1.0, sparse_weight=1.0)
    want = jss.sharded_hybrid_section_topk(
        j_t["dense"], j_t["sketch"], _j(data["sp_ids"], jax_mesh), _j(data["sp_w"], jax_mesh),
        _jr(data["dq"], jax_mesh), _jr(data["sq"], jax_mesh), _jr(data["q_ids"], jax_mesh),
        _jr(data["q_w"], jax_mesh), mask=_j(data["mask"], jax_mesh), mesh=jax_mesh,
        dense_scale=scales["dense"][0], sketch_scale=scales["sketch"][0], rescore_impl="oneshot",
        table_select="exact", ft_arm=j_ft, block_cols=bc, interpret=True, **common,
    )
    got = ss.sharded_hybrid_section_topk(
        t_rows["dense"], t_rows["sketch"], _t(data["sp_ids"], mesh), _t(data["sp_w"], mesh),
        _r(data["dq"]), _r(data["sq"]), _r(data["q_ids"]), _r(data["q_w"]),
        mask=_t(data["mask"], mesh), mesh=mesh, dense_scale=scales["dense"][1],
        sketch_scale=scales["sketch"][1], ft_arm=t_ft, block_cols=bc, **common,
    )
    _assert_pairs(got, want)
    # At the full table depth the single-device section program, whose table
    # is the shards' tables side by side, returns the same rows.
    full = dict(common, depth=(4096 // bc) * 128)
    queries = (_r(data["dq"]), _r(data["sq"]), _r(data["q_ids"]), _r(data["q_w"]))
    sp = (_r(data["sp_ids"]), _r(data["sp_w"]))
    if three_way:
        single = hybrid_section_topk_3way(
            whole["dense"], whole["sketch"], *sp, whole["ft_sketch"], _r(ft["ft_ids"]),
            _r(ft["ft_w"]), *queries, _r(ft["ft_qproj"]), _r(ft["ft_qids"]), _r(ft["ft_qw"]),
            mask=_r(data["mask"]), dense_scale=s_whole["dense"], sketch_scale=s_whole["sketch"],
            ft_scale=s_whole["ft_sketch"], block_cols=bc, **full,
        )
    else:
        single = hybrid_section_topk(
            whole["dense"], whole["sketch"], *sp, *queries, mask=_r(data["mask"]),
            dense_scale=s_whole["dense"], sketch_scale=s_whole["sketch"], block_cols=bc, **full,
        )
    sharded_full = ss.sharded_hybrid_section_topk(
        t_rows["dense"], t_rows["sketch"], _t(data["sp_ids"], mesh), _t(data["sp_w"], mesh),
        *queries, mask=_t(data["mask"], mesh), mesh=mesh, dense_scale=scales["dense"][1],
        sketch_scale=scales["sketch"][1], ft_arm=t_ft, block_cols=bc, **full,
    )
    _assert_pairs(sharded_full, single)


# -- sharded_sparse_topk -------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 8, 30])
@pytest.mark.parametrize("block", [16, 64, 8192])
def test_sharded_sparse_matches_jax(meshes, k, block):
    from verbatim_rag_tpu_torch.ops.sparse import sparse_topk

    jax_mesh, mesh = meshes
    rng = np.random.default_rng(k + block)
    n, m, vocab, b = 512, 8, 64, 3
    ids = rng.integers(1, vocab, size=(n, m)).astype(np.int32)
    weights = rng.random(size=(n, m)).astype(np.float32)
    q = np.zeros((b, vocab), np.float32)
    q[0, [3, 9]] = [1.0, 2.0]
    q[1, [5]] = [1.5]
    q[2, rng.integers(1, vocab, 6)] = rng.random(6)
    mask = np.ones(n, bool)
    mask[::7] = False
    want = jss.sharded_sparse_topk(
        _j(ids, jax_mesh), _j(weights, jax_mesh), _jr(q, jax_mesh), k, _j(mask, jax_mesh),
        jax_mesh, block=block,
    )
    got = ss.sharded_sparse_topk(
        _t(ids, mesh), _t(weights, mesh), _r(q), k, _t(mask, mesh), mesh, block=block
    )
    _assert_pairs(got, want)
    _assert_pairs(got, sparse_topk(_r(ids), _r(weights), _r(q), k, _r(mask), block=block))
