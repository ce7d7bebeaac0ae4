"""The row-sharded searches across processes: JAX's DCN path
(`scripts/dcn_two_process_demo.py`) in the port.

Gloo processes on the CPU (2 and 4 ranks, each a ``["cpu"] * 2`` mesh) run
the five functions of `parallel/sharded_search.py` over the group's rows:
each rank holds only its block (`shard_rows` of the full host array), and
the rows are laid out as JAX's ``P(("dp", "tp"))`` over a global mesh, ranks
first, then each rank's positions. Inputs come from a numpy seed, with
unique term ids per row (the rescore's at-most-one-match contract, as the
demo makes them). Each result is held to three references:

(a) the port's one-process mesh with the same number of shards
    (``["cpu"] * 2W``), computed in the same worker after its group is
    gone: bit-equal, scores and rows;
(b) JAX's same function on a ``dp=W × tp=2`` mesh of conftest's CPU
    devices: rows equal wherever the fused score is unique, fused RRF scores
    within rtol 1e-5 / atol 1e-7 (the demo's), float32 scores within 5e-4;
(c) at depth ≥ rows per shard, JAX's single-device `hybrid_fused_topk` and
    `hybrid_section_topk` (the demo's check, :111-168), with (b)'s limits.

A planted fault (one rank's global offsets shifted by a shard) must fail
(a), and a rank that passes rows of unequal size, or another rank's block,
must raise on every rank. The section programs run JAX in interpret mode
(``table_select="exact"``, as the port always selects exactly).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from verbatim_rag_tpu.ops.dense import quantize_rows_int8 as jax_quantize_int8
from verbatim_rag_tpu.ops.hybrid import hybrid_fused_topk as jax_hybrid_fused_topk
from verbatim_rag_tpu.ops.section import hybrid_section_topk as jax_hybrid_section_topk
from verbatim_rag_tpu.parallel import sharded_search as jss
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu_torch.parallel import distributed, make_mesh, row_sharding
from verbatim_rag_tpu_torch.parallel import sharded_search as ss

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

REPO = Path(__file__).resolve().parent.parent
#: Positions of each rank's mesh, rows a position (a section block).
TP, N_LOCAL, BLOCK = 2, 256, 256
D, DP, M, VOCAB, B, QM = 32, 64, 8, 500, 4, 4
RRF_RTOL, RRF_ATOL, F32_TOL = 1e-5, 1e-7, 5e-4
#: Shallow arms: depth below a shard's rows; the full-depth cases take
#: every row of a shard (hybrid) or every entry of a shard's table (section).
SHALLOW = dict(k=5, fetch_k=10, depth=32)
SECTION_DEPTH = 96
SECTION_FULL_DEPTH = N_LOCAL // BLOCK * 128
CASES = (
    "dense_f32", "dense_int8", "projected_int8", "hybrid_f32", "hybrid_3way_int8", "hybrid_full",
    "section_int8", "section_3way_f32", "section_full", "sparse",
)
#: Arms a call gathers over the group (one pair ``all_gather`` each).
ARMS = dict(dense_f32=1, dense_int8=1, projected_int8=1, hybrid_f32=2, hybrid_3way_int8=3, hybrid_full=2,
            section_int8=2, section_3way_f32=3, section_full=2, sparse=1)


def _unique_ids(rng, rows: int, width: int) -> np.ndarray:
    return np.stack([rng.choice(np.arange(1, VOCAB), width, replace=False) for _ in range(rows)]).astype(np.int32)


def _unit(rng, shape) -> np.ndarray:
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def make_data(n_ranks: int, seed: int = 5) -> dict:
    """The group's rows (``n_ranks · TP · N_LOCAL``) and one query batch."""
    n = n_ranks * TP * N_LOCAL
    rng = np.random.default_rng(seed + n_ranks)
    mask = np.ones(n, bool)
    mask[::13] = False
    data = dict(
        dense=_unit(rng, (n, D)), sketch=rng.normal(size=(n, DP)).astype(np.float32),
        ft_sketch=rng.normal(size=(n, DP)).astype(np.float32),
        sp_ids=_unique_ids(rng, n, M), sp_w=(rng.random((n, M)) + 0.1).astype(np.float32),
        ft_ids=_unique_ids(rng, n, M), ft_w=(rng.random((n, M)) + 0.1).astype(np.float32),
        dq=_unit(rng, (B, D)), sq=rng.normal(size=(B, DP)).astype(np.float32),
        ft_q=rng.normal(size=(B, DP)).astype(np.float32),
        q_ids=_unique_ids(rng, B, QM), q_w=(rng.random((B, QM)) + 0.1).astype(np.float32),
        ft_qids=_unique_ids(rng, B, QM), ft_qw=(rng.random((B, QM)) + 0.1).astype(np.float32),
        mask=mask,
    )
    q_dense = np.zeros((B, VOCAB), np.float32)
    for b in range(B):
        q_dense[b, data["q_ids"][b]] = data["q_w"][b]
    data["q_dense"] = q_dense
    for name in ("dense", "sketch", "ft_sketch"):
        codes, scale = jax_quantize_int8(data[name])
        data[f"{name}_i8"], data[f"{name}_scale"] = np.asarray(codes), np.asarray(scale)
    return data


#: The worker: one rank of the group runs every case over its block, then,
#: with its group gone, the same cases on a one-process mesh of as many
#: shards. ``fault`` plants one: rank 1's global offsets shifted by a shard
#: ("offset"), a block of half the rows ("unequal") or rank 0's block passed
#: as its own ("foreign").
WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    from verbatim_rag_tpu_torch.parallel import distributed, make_mesh
    from verbatim_rag_tpu_torch.parallel import sharded_search as ss
    from verbatim_rag_tpu_torch.parallel.mesh import row_sharding

    out_path, data_path, fault, cases = sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
    data = {k: torch.from_numpy(v) for k, v in np.load(data_path).items()}
    SHALLOW = cases.pop("shallow")

    def run(name, place, mesh):
        d = data
        t = lambda key: place(d[key], mesh)
        full = d["dense"].shape[0]
        if name == "dense_f32":
            return ss.sharded_dense_topk(t("dense"), d["dq"], 10, t("mask"), mesh)
        if name == "dense_int8":
            return ss.sharded_dense_topk(t("dense_i8"), d["dq"], 10, t("mask"), mesh, corpus_scale=t("dense_scale"))
        if name == "projected_int8":
            return ss.sharded_projected_sparse_topk(
                t("sketch_i8"), t("sp_ids"), t("sp_w"), d["sq"], d["q_ids"], d["q_w"], 8, 32, t("mask"), mesh,
                sketch_scale=t("sketch_scale"), rescore_impl="pallas")
        common = (d["dq"], d["sq"], d["q_ids"], d["q_w"])
        ft = lambda sk, scale: (t(sk), t("ft_ids"), t("ft_w"), d["ft_q"], d["ft_qids"], d["ft_qw"], 0.25,
                                scale and t(scale))
        if name == "hybrid_f32":
            return ss.sharded_hybrid_topk(t("dense"), t("sketch"), t("sp_ids"), t("sp_w"), *common, mask=t("mask"),
                                          mesh=mesh, dense_weight=0.4, sparse_weight=0.35, **SHALLOW)
        if name == "hybrid_3way_int8":
            return ss.sharded_hybrid_topk(
                t("dense_i8"), t("sketch_i8"), t("sp_ids"), t("sp_w"), *common, mask=t("mask"), mesh=mesh,
                dense_weight=0.4, sparse_weight=0.35, dense_scale=t("dense_scale"),
                sketch_scale=t("sketch_scale"), rescore_impl="pallas", ft_arm=ft("ft_sketch_i8", "ft_sketch_scale"),
                **SHALLOW)
        if name == "hybrid_full":
            return ss.sharded_hybrid_topk(t("dense"), t("sketch"), t("sp_ids"), t("sp_w"), *common, k=10,
                                          fetch_k=20, depth=full, mask=t("mask"), mesh=mesh,
                                          dense_weight=0.6, sparse_weight=0.4)
        section = dict(block_cols=cases["block"], dense_weight=1.0, sparse_weight=1.0)
        if name == "section_int8":
            return ss.sharded_hybrid_section_topk(
                t("dense_i8"), t("sketch_i8"), t("sp_ids"), t("sp_w"), *common, k=6, fetch_k=16,
                depth=cases["section_depth"], mask=t("mask"), mesh=mesh, dense_scale=t("dense_scale"),
                sketch_scale=t("sketch_scale"), **section)
        if name == "section_3way_f32":
            return ss.sharded_hybrid_section_topk(
                t("dense"), t("sketch"), t("sp_ids"), t("sp_w"), *common, k=6, fetch_k=16,
                depth=cases["section_depth"], mask=t("mask"), mesh=mesh, ft_arm=ft("ft_sketch", None), **section)
        if name == "section_full":
            return ss.sharded_hybrid_section_topk(
                t("dense_i8"), t("sketch_i8"), t("sp_ids"), t("sp_w"), *common, k=6, fetch_k=16,
                depth=cases["section_full_depth"], mask=t("mask"), mesh=mesh, dense_scale=t("dense_scale"),
                sketch_scale=t("sketch_scale"), **section)
        if name == "sparse":
            return ss.sharded_sparse_topk(t("sp_ids"), t("sp_w"), d["q_dense"], 8, t("mask"), mesh, block=64)
        raise ValueError(name)

    assert distributed.initialize() is True
    world, rank = distributed.process_count(), distributed.process_index()
    mesh = make_mesh(dp=1, tp=cases["tp"], devices=["cpu"] * cases["tp"])
    out = {"backend": np.array(str(torch.distributed.get_backend()))}
    if fault == "offset" and rank == 1:
        ss._Layout.offset = lambda self, i: (self.first + i + 1) * self.n_local
    if fault in ("unequal", "foreign"):
        if fault == "unequal" and rank == 1:
            block = lambda x, m: ss.shard_process_rows(x[: x.shape[0] // (2 * world)], m)
        elif fault == "foreign" and rank == 1:
            block = lambda x, m: ss.RowSharded(ss.shard_rows(x, m).shards, 0, world)
        else:
            block = ss.shard_rows
        try:
            run("dense_f32", block, mesh)
            out["raised"] = np.array("")
        except ValueError as err:
            out["raised"] = np.array(str(err))
    else:
        for name in cases["names"]:
            before = ss.gathers
            scores, rows = run(name, ss.shard_rows, mesh)
            out[f"{name}_scores"], out[f"{name}_rows"] = scores.numpy(), rows.numpy()
            out[f"{name}_gathers"] = np.array(ss.gathers - before)
        out["placed_rows"] = np.array(ss.shard_rows(data["dense"], mesh).shards[0].shape[0])
    torch.distributed.destroy_process_group()
    assert distributed.process_count() == 1
    if fault != "unequal" and fault != "foreign":
        one = make_mesh(dp=world, tp=cases["tp"], devices=["cpu"] * (world * cases["tp"]))
        for name in cases["names"]:
            scores, rows = run(name, row_sharding, one)
            out[f"ref_{name}_scores"], out[f"ref_{name}_rows"] = scores.numpy(), rows.numpy()
    np.savez(out_path, **out)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_group(tmp_path: Path, n_ranks: int, data: dict, fault: str = "none") -> list[dict]:
    """``n_ranks`` gloo processes run the worker; each rank's outputs."""
    import json

    np.savez(tmp_path / "data.npz", **data)
    cases = dict(names=list(CASES), tp=TP, block=BLOCK, section_depth=SECTION_DEPTH,
                 section_full_depth=SECTION_FULL_DEPTH, shallow=SHALLOW)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n_ranks), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp_path / f"rank{rank}.npz"), str(tmp_path / "data.npz"), fault,
             json.dumps(cases)],
            cwd=REPO, env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(n_ranks)
    ]
    try:
        outputs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * n_ranks, [err[-2000:] for _, err in outputs]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n_ranks)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def group(request, tmp_path_factory):
    n_ranks = request.param
    data = make_data(n_ranks)
    return n_ranks, data, spawn_group(tmp_path_factory.mktemp(f"group{n_ranks}"), n_ranks, data)


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    data = make_data(2)
    return {
        fault: spawn_group(tmp_path_factory.mktemp(fault), 2, data, fault)
        for fault in ("offset", "unequal", "foreign")
    }


def _pairs(rank: dict, name: str, prefix: str = "") -> tuple[np.ndarray, np.ndarray]:
    return rank[f"{prefix}{name}_scores"], rank[f"{prefix}{name}_rows"]


# -- (a) the one-process mesh ----------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_group_equals_the_one_process_mesh(group, name):
    """Every rank's scores and rows bit-equal to one process's mesh of the
    same shards, and to each other."""
    _, _, ranks = group
    ref_s, ref_r = _pairs(ranks[0], name, "ref_")
    assert (ref_r >= 0).any()
    for rank in ranks:
        np.testing.assert_array_equal(_pairs(rank, name, "ref_")[0], ref_s)
        scores, rows = _pairs(rank, name)
        np.testing.assert_array_equal(rows, ref_r)
        np.testing.assert_array_equal(scores, ref_s)


def test_each_arm_gathers_once_on_the_group_backend(group):
    n_ranks, data, ranks = group
    expected = distributed.BACKEND if torch.distributed.is_nccl_available() else "gloo"
    for rank in ranks:
        assert str(rank["backend"]) == expected
        assert {name: int(rank[f"{name}_gathers"]) for name in CASES} == ARMS
        # A rank holds its block only: N / W rows over its TP positions.
        assert int(rank["placed_rows"]) == data["dense"].shape[0] // n_ranks // TP


# -- (b) JAX's same function on a global mesh ---------------------------------------------------


def _jax_mesh(n_ranks: int):
    return jax_make_mesh(dp=n_ranks, tp=TP, devices=jax.devices()[: n_ranks * TP])


def _rows_where_unique(got_rows, want_scores, want_rows, tol: float = 1e-9) -> None:
    """Rows equal wherever the reference's fused score is unique in its row
    (RRF ties may permute between merge orders)."""
    for i in range(want_scores.shape[0]):
        gaps = np.abs(np.diff(want_scores[i])) > tol
        unique = np.concatenate([[True], gaps]) & np.concatenate([gaps, [True]])
        np.testing.assert_array_equal(got_rows[i][unique], want_rows[i][unique])


def _fused(got, want) -> None:
    np.testing.assert_allclose(got[0], want[0], rtol=RRF_RTOL, atol=RRF_ATOL)
    _rows_where_unique(got[1], np.asarray(want[0]), np.asarray(want[1]))


def _jax_case(name: str, data: dict, mesh):
    j = lambda key: jss.shard_rows(jnp.asarray(data[key]), mesh)
    r = lambda key: jss.replicate(jnp.asarray(data[key]), mesh)
    col = lambda key: jax.device_put(jnp.asarray(data[key].T), NamedSharding(mesh, P(None, ("dp", "tp"))))
    common = (r("dq"), r("sq"), r("q_ids"), r("q_w"))
    ft = lambda sk, scale: (sk, j("ft_ids"), j("ft_w"), r("ft_q"), r("ft_qids"), r("ft_qw"), 0.25, scale)
    n = data["dense"].shape[0]
    if name == "dense_f32":
        return jss.sharded_dense_topk(j("dense"), r("dq"), 10, j("mask"), mesh)
    if name == "dense_int8":
        return jss.sharded_dense_topk(j("dense_i8"), r("dq"), 10, j("mask"), mesh, corpus_scale=j("dense_scale"))
    if name == "projected_int8":
        return jss.sharded_projected_sparse_topk(
            j("sketch_i8"), j("sp_ids"), j("sp_w"), r("sq"), r("q_ids"), r("q_w"), 8, 32, j("mask"), mesh,
            sketch_scale=j("sketch_scale"))
    if name == "hybrid_f32":
        return jss.sharded_hybrid_topk(j("dense"), j("sketch"), j("sp_ids"), j("sp_w"), *common, mask=j("mask"),
                                       mesh=mesh, dense_weight=0.4, sparse_weight=0.35, **SHALLOW)
    if name == "hybrid_3way_int8":
        return jss.sharded_hybrid_topk(
            j("dense_i8"), j("sketch_i8"), j("sp_ids"), j("sp_w"), *common, mask=j("mask"), mesh=mesh,
            dense_weight=0.4, sparse_weight=0.35, dense_scale=j("dense_scale"), sketch_scale=j("sketch_scale"),
            ft_arm=ft(j("ft_sketch_i8"), j("ft_sketch_scale")), **SHALLOW)
    if name == "hybrid_full":
        return jss.sharded_hybrid_topk(j("dense"), j("sketch"), j("sp_ids"), j("sp_w"), *common, k=10, fetch_k=20,
                                       depth=n, mask=j("mask"), mesh=mesh, dense_weight=0.6, sparse_weight=0.4)
    section = dict(block_cols=BLOCK, dense_weight=1.0, sparse_weight=1.0, rescore_impl="oneshot",
                   table_select="exact", interpret=True, k=6, fetch_k=16)
    if name in ("section_int8", "section_full"):
        depth = SECTION_DEPTH if name == "section_int8" else SECTION_FULL_DEPTH
        return jss.sharded_hybrid_section_topk(
            col("dense_i8"), col("sketch_i8"), j("sp_ids"), j("sp_w"), *common, depth=depth, mask=j("mask"),
            mesh=mesh, dense_scale=j("dense_scale"), sketch_scale=j("sketch_scale"), **section)
    if name == "section_3way_f32":
        return jss.sharded_hybrid_section_topk(
            col("dense"), col("sketch"), j("sp_ids"), j("sp_w"), *common, depth=SECTION_DEPTH, mask=j("mask"),
            mesh=mesh, ft_arm=ft(col("ft_sketch"), None), **section)
    if name == "sparse":
        return jss.sharded_sparse_topk(j("sp_ids"), j("sp_w"), r("q_dense"), 8, j("mask"), mesh, block=64)
    raise ValueError(name)


@pytest.mark.parametrize("name", CASES)
def test_group_matches_jax_on_a_global_mesh(group, name, monkeypatch):
    monkeypatch.setenv("VERBATIM_SECTION_INTERPRET", "1")
    n_ranks, data, ranks = group
    want = tuple(np.asarray(x) for x in _jax_case(name, data, _jax_mesh(n_ranks)))
    got = _pairs(ranks[0], name)
    if name.startswith(("hybrid", "section")):
        _fused(got, want)
    else:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=F32_TOL, atol=F32_TOL)


# -- (c) JAX's single-device programs at depth ≥ rows per shard ----------------------------------


def test_hybrid_at_full_depth_matches_jax_single_device(group):
    _, data, ranks = group
    n = data["dense"].shape[0]
    want = jax_hybrid_fused_topk(
        *(jnp.asarray(data[k]) for k in ("dense", "sketch", "sp_ids", "sp_w", "dq", "sq", "q_ids", "q_w")),
        k=10, fetch_k=20, depth=n, mask=jnp.asarray(data["mask"]), dense_weight=0.6, sparse_weight=0.4,
        exact_topk=True,
    )
    want = tuple(np.asarray(x) for x in want)
    assert (want[1] >= 0).any()
    _fused(_pairs(ranks[0], "hybrid_full"), want)


def test_section_at_full_depth_matches_jax_single_device(group, monkeypatch):
    monkeypatch.setenv("VERBATIM_SECTION_INTERPRET", "1")
    _, data, ranks = group
    n = data["dense"].shape[0]
    want = jax_hybrid_section_topk(
        jnp.asarray(data["dense_i8"].T), jnp.asarray(data["sketch_i8"].T),
        *(jnp.asarray(data[k]) for k in ("sp_ids", "sp_w", "dq", "sq", "q_ids", "q_w")),
        k=6, fetch_k=16, depth=n // BLOCK * 128, mask=jnp.asarray(data["mask"]), dense_weight=1.0,
        sparse_weight=1.0, dense_scale=jnp.asarray(data["dense_scale"]),
        sketch_scale=jnp.asarray(data["sketch_scale"]), rescore_impl="oneshot", table_select="exact",
        block_cols=BLOCK, dot_chunk=BLOCK, interpret=True,
    )
    want = tuple(np.asarray(x) for x in want)
    assert (want[1] >= 0).any()
    _fused(_pairs(ranks[0], "section_full"), want)


# -- placement and faults ------------------------------------------------------------------------


def test_shard_rows_keeps_only_this_ranks_block(monkeypatch):
    """Rank 2 of 4 keeps rows [N/2, 3N/4) of a full host array, in its
    mesh's positions, tagged as its block; a rank-local block placed by
    `shard_process_rows` is the same array; rows that do not divide over the
    group raise. Without a group both are `shard_rows` of the mesh."""
    mesh = make_mesh(dp=1, tp=2, devices=["cpu"] * 2)
    x = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
    whole = ss.shard_rows(x, mesh)
    assert (whole.rank, whole.ranks, whole.rows_per_shard) == (0, 1, 32)
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    placed = ss.shard_rows(x, mesh)
    assert (placed.rank, placed.ranks) == (2, 4) and placed.shape == (16, 3)
    torch.testing.assert_close(placed.shards[0], x[32:40])
    torch.testing.assert_close(placed.shards[1], x[40:48])
    local = ss.shard_process_rows(x[32:48], mesh)
    assert (local.rank, local.ranks) == (2, 4)
    assert all(torch.equal(a, b) for a, b in zip(local.shards, placed.shards))
    assert placed.map(lambda s: s * 2).ranks == 4
    with pytest.raises(ValueError, match="shard evenly over 4 processes"):
        ss.shard_rows(x[:62], mesh)
    # Rows placed for one process alone (as a store's) raise before any
    # collective: no rank is left waiting.
    q = torch.ones(2, 3)
    with pytest.raises(ValueError, match="process-local rows in a group of 4"):
        ss.sharded_dense_topk(whole, q, 2, row_sharding(torch.ones(64, dtype=torch.bool), mesh), mesh)


def test_a_planted_offset_fault_fails_the_comparison(faults):
    """Rank 1 shifts its global offsets by one shard: every rank's merged
    rows then differ from the one-process mesh's (the check above fails)."""
    for rank in faults["offset"]:
        differ = [name for name in CASES if not np.array_equal(_pairs(rank, name)[1], _pairs(rank, name, "ref_")[1])]
        assert differ == list(CASES)


@pytest.mark.parametrize("fault", ["unequal", "foreign"])
def test_rows_off_the_layout_raise_on_every_rank(faults, fault):
    """A rank holding half the rows of the others, or rank 0's block in
    rank 1's hands: both ranks raise ``ValueError`` (neither is left waiting
    in a collective)."""
    messages = [str(rank["raised"]) for rank in faults[fault]]
    assert all(messages), messages
    if fault == "unequal":
        assert all("unequal blocks" in m for m in messages)
    else:
        assert all("rank(s) [1] of 2" in m for m in messages)
