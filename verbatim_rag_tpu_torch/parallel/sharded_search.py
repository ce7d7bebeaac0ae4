"""Distributed retrieval: a row-sharded index, a search per shard, and a
merge of the shards' (score, global row) pairs (port of
`verbatim_rag_tpu/parallel/sharded_search.py`).

The JAX package runs each search as one ``shard_map`` program: every device
scores its own rows and selects locally, an ``all_gather`` over the combined
``("dp", "tp")`` axis brings every shard's k pairs to each device, and a final
``lax.top_k`` picks the global k, O(devices·k) traffic. The port keeps that
dataflow in one process. Each shard runs the port's single-device op on its
own device, with the impl knobs passed per shard (`ops/hybrid.py::rescore_fn`,
`ops/dense.py::candidate_topk`, `ops/section.py::section_bucket_tables` /
`table_topk`), so each kernel launches once per shard. A shard's rows are
made global by adding ``shard_index * rows_per_shard``. The merge
concatenates the shards' pairs in shard order (dp-major, the ``all_gather``
order) on the mesh's first device and selects with `ops/dense.py::topk`,
which breaks ties lowest index first as ``lax.top_k`` does.

Row-sharded arguments are :class:`~.mesh.RowSharded` arrays, or
:class:`~verbatim_rag_tpu_torch.ops.dense.Int4Rows` of them; replicated
arguments are plain tensors (copied to each shard's device) or the lists
`replicate` makes.

Across processes (JAX's mesh over every device of every process, the DCN
path of `scripts/dcn_two_process_demo.py`): in a ``torch.distributed`` group
of W > 1 processes each rank passes its own block of the rows
(:func:`shard_rows` of the full host array, or :func:`shard_process_rows` of
a block the rank made itself), and the rows are laid out as JAX's
``P(("dp", "tp"))`` over the global mesh: ranks in order, then each rank's
mesh positions in order, so that position i of rank p holds global shard
``p·P + i`` (P positions a rank). Every rank must hold the same number of
rows in the same number of positions (checked with one small ``all_gather``
a call; unequal blocks raise). Each arm's merge gathers this rank's
(score, global row) pairs over the group with one ``all_gather`` (NCCL for
CUDA tensors, gloo for CPU ones, as the group's backend says), concatenates
them in global shard order and selects with `ops/dense.py::topk`, so the
result is the one-process merge of the same shards, ties included; RRF and
the final top-k then run on every rank, which all return the same result.
A failed collective raises. Without a group, or in a group of one process,
every function runs the one-process path above.
"""

from __future__ import annotations

import torch

from verbatim_rag_tpu_torch.ops.dense import NEG_INF, Int4Rows, dense_scores, topk

from . import distributed
from .mesh import Mesh, RowSharded, replicated, row_sharding

#: Pair ``all_gather``\ s made by the group path since the last reset (one
#: an arm a call; the layout check is not counted).
gathers = 0


def shard_rows(x: torch.Tensor, mesh: Mesh) -> RowSharded:
    """Place a [N, ...] array row-sharded over the whole mesh.

    In a process group of W > 1 processes ``x`` is the full host array (the
    same on every rank) and this rank keeps only its block p of W, rows
    ``[p·N/W, (p+1)·N/W)``, over its own mesh: what JAX's
    ``make_array_from_callback`` gives each process of a global mesh.
    """
    world = distributed.process_count()
    if world == 1:
        return row_sharding(x, mesh)
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not shard evenly over {world} processes")
    n = x.shape[0] // world
    rank = distributed.process_index()
    return shard_process_rows(x[rank * n : (rank + 1) * n], mesh)


def shard_process_rows(block: torch.Tensor, mesh: Mesh) -> RowSharded:
    """This rank's block of the group's rows ([N/W, ...], made or loaded by
    the rank itself), row-sharded over its mesh: JAX's
    ``make_array_from_process_local_data``. Without a group it is
    :func:`shard_rows` of ``block``."""
    placed = row_sharding(block, mesh)
    return RowSharded(placed.shards, distributed.process_index(), distributed.process_count())


def replicate(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A copy of ``x`` on every device of the mesh."""
    return replicated(x, mesh)


def _shard(x, i: int):
    """Shard ``i`` of a row-sharded argument (None stays None)."""
    if x is None:
        return None
    if isinstance(x, Int4Rows):
        return Int4Rows(_shard(x.packed, i), _shard(x.scale, i))
    return x.shards[i]


def _replica(x, i: int, device: torch.device):
    """Replica ``i`` of a replicated argument, on ``device``."""
    if isinstance(x, (list, tuple)):
        return x[i]
    return x.to(device)


def _placed(x) -> RowSharded:
    """The `RowSharded` of a row-sharded argument (an `Int4Rows`' codes)."""
    return x.packed if isinstance(x, Int4Rows) else x


def _n_local(x) -> int:
    return _placed(x).rows_per_shard


def _devices(mesh: Mesh, x) -> list[torch.device]:
    shards = _placed(x).shards
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards on a mesh of {mesh.size} devices")
    return [s.device for s in shards]


def _pad_cols(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Right-pad the last axis to ``width`` with ``fill`` (no-op if wide enough)."""
    short = width - x.shape[-1]
    if short <= 0:
        return x
    pad = torch.full((*x.shape[:-1], short), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=-1)


class _Layout:
    """Where this process's mesh positions sit among the global shards:
    position i holds global shard ``first + i`` of ``n_local`` rows, and
    ``group`` says whether the shards span a process group."""

    def __init__(self, first: int, n_local: int, group: bool):
        self.first, self.n_local, self.group = first, n_local, group

    def offset(self, i: int) -> int:
        """The global row of position i's first row."""
        return (self.first + i) * self.n_local


def _layout(mesh: Mesh, *row_args) -> _Layout:
    """The layout of the row-sharded arguments (None entries skipped). In a
    group of W > 1 processes each must be this rank's block of W, every
    block in P = ``mesh.size`` positions of the same rows, and every rank
    must hold as many. The ranks agree on that with one ``all_gather`` of
    (fit, P, rows a position), so that a rank whose rows do not fit raises
    ``ValueError`` on every rank alike instead of leaving the others waiting
    in a later collective. Rows placed for one process alone (as a
    store's) raise at once, before any collective."""
    placed = [_placed(a) for a in row_args if a is not None]
    n_local = placed[0].rows_per_shard
    world = distributed.process_count()
    if world == 1:
        return _Layout(0, n_local, group=False)
    rank = distributed.process_index()
    if all(a.ranks == 1 for a in placed):
        raise ValueError(
            f"process-local rows in a group of {world} processes: each rank passes its own block "
            "of the group's rows (shard_rows / shard_process_rows); a store does not span processes"
        )
    misfit = next(
        (
            f"block {a.rank} of {a.ranks} in {len(a.shards)} shards of {a.rows_per_shard} rows"
            for a in placed
            if (a.rank, a.ranks) != (rank, world) or a.rows_per_shard != n_local or len(a.shards) != mesh.size
        ),
        None,
    )
    mine = torch.tensor([misfit is None, mesh.size, n_local], dtype=torch.int64, device=placed[0].device)
    every = [torch.empty_like(mine) for _ in range(world)]
    torch.distributed.all_gather(every, mine)
    held = [tuple(t.tolist()) for t in every]
    unfit = [r for r, (fit, _, _) in enumerate(held) if not fit]
    if unfit:
        raise ValueError(
            f"rank(s) {unfit} of {world} passed rows that are not their own block of the group's "
            f"layout{f' (rank {rank} holds {misfit})' if misfit else ''}; each rank passes its own "
            "block, in as many positions of as many rows (shard_rows / shard_process_rows)"
        )
    if len({h[1:] for h in held}) != 1:
        raise ValueError(
            f"ranks hold unequal blocks, (positions, rows a position) by rank: {[h[1:] for h in held]}; "
            "every rank must hold the same number of rows"
        )
    return _Layout(rank * mesh.size, n_local, group=True)


def _gather_pairs(scores: torch.Tensor, rows: torch.Tensor):
    """This rank's [B, P·k] (score, global row) pairs → the group's
    [B, W·P·k], rank-major, with one ``all_gather`` (both packed in float64,
    which holds a float32 score and a row below 2^53 exactly)."""
    global gathers
    packed = torch.stack([scores.double(), rows.double()])
    parts = [torch.empty_like(packed) for _ in range(distributed.process_count())]
    torch.distributed.all_gather(parts, packed)
    gathers += 1
    every = torch.cat(parts, dim=2)
    return every[0].to(scores.dtype), every[1].long()


def _merge(scores: list[torch.Tensor], rows: list[torch.Tensor], width: int, layout: _Layout):
    """The shards' (score, global row) pairs, concatenated in shard order on
    the first shard's device (and over the group in rank order), then their
    top-``width`` (at most all of them)."""
    dev = scores[0].device
    flat_s = torch.cat([s.to(dev) for s in scores], dim=1)
    flat_i = torch.cat([r.to(dev).long() for r in rows], dim=1)
    if layout.group:
        flat_s, flat_i = _gather_pairs(flat_s, flat_i)
    top, pos = topk(flat_s, min(width, flat_s.shape[1]))
    return top, torch.gather(flat_i, 1, pos)


def _globalize(idx: torch.Tensor, valid: torch.Tensor, offset: int) -> torch.Tensor:
    """Local rows → global rows; −1 where ``valid`` is False."""
    return torch.where(valid, idx.long() + offset, -1)


def _weights(raw, device) -> torch.Tensor:
    from verbatim_rag_tpu_torch.ops.hybrid import _arm_weights

    return _arm_weights(tuple(raw), device)


def sharded_dense_topk(
    corpus, queries, k: int, mask: RowSharded, mesh: Mesh, exact_topk: bool = True,
    corpus_scale=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact distributed top-k: (scores [B, k], global row indices [B, k]).

    ``corpus``: [N, d] row-sharded (bf16/f32, int8 with ``corpus_scale``, or
    `Int4Rows`); ``queries``: [B, d] replicated, row-normalized. Selection is
    exact whatever ``exact_topk`` says (the port has no approximate top-k).
    """
    del exact_topk
    layout = _layout(mesh, corpus, mask, corpus_scale)
    scores, rows = [], []
    for i, dev in enumerate(_devices(mesh, corpus)):
        n_local = _n_local(corpus)
        s = dense_scores(_shard(corpus, i), _replica(queries, i, dev), _shard(corpus_scale, i))
        s = torch.where(_shard(mask, i)[None, :], s, NEG_INF)
        top, idx = topk(s, min(k, n_local))
        scores.append(top)
        rows.append(idx + layout.offset(i))
    return _merge(scores, rows, k, layout)


def _projected_arm_local(
    sketch, ids, w, mask, qproj, qids, qw, sscale, depth: int, width: int,
    exact_topk: bool, rescore_impl: str, candidate_impl: str, offset: int,
):
    """One shard's projected arm: local sketch candidates → local exact
    rescore → its top-``width`` as (exact scores, global rows; −1 missing)."""
    from verbatim_rag_tpu_torch.ops.dense import candidate_topk
    from verbatim_rag_tpu_torch.ops.hybrid import rescore_fn

    local_depth = min(depth, sketch.shape[0])
    c_top, cand = candidate_topk(
        sketch, qproj, local_depth, mask, sscale, exact_topk, candidate_impl
    )
    cand = torch.where(c_top > NEG_INF / 2, cand, -1).to(torch.int32).contiguous()
    exact = rescore_fn(rescore_impl)(cand, ids, w, qids, qw)
    r_top, r_pos = topk(exact, min(width, local_depth))
    idx = torch.gather(cand, 1, r_pos)
    return r_top, _globalize(idx, r_top > NEG_INF / 2, offset)


def sharded_projected_sparse_topk(
    sketch_corpus, sp_ids: RowSharded, sp_w: RowSharded, sketch_q, q_ids, q_w,
    k: int, depth: int, mask: RowSharded, mesh: Mesh, exact_topk: bool = True,
    sketch_scale=None, rescore_impl: str = "scan", candidate_impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed projected sparse search: per-shard sketch candidates and
    exact rescore, merged by exact score (shard-independent, so the merge is
    exact over the union of the shards' candidates). Returns (exact scores
    [B, k], global rows [B, k]; −1 where no term overlaps)."""
    from verbatim_rag_tpu_torch.ops.hybrid import validate_candidate_impl

    impl = validate_candidate_impl(candidate_impl)
    layout = _layout(mesh, sketch_corpus, sp_ids, sp_w, mask, sketch_scale)
    scores, rows = [], []
    for i, dev in enumerate(_devices(mesh, sketch_corpus)):
        top, idx = _projected_arm_local(
            _shard(sketch_corpus, i), _shard(sp_ids, i), _shard(sp_w, i), _shard(mask, i),
            _replica(sketch_q, i, dev), _replica(q_ids, i, dev), _replica(q_w, i, dev),
            _shard(sketch_scale, i), depth, k, exact_topk, rescore_impl, impl, layout.offset(i),
        )
        scores.append(top)
        rows.append(idx)
    top, idx = _merge(scores, rows, k, layout)
    # A zero exact score (no term overlap) is not a hit.
    idx = torch.where(top > 0.0, idx, -1)
    return _pad_cols(top, k, NEG_INF), _pad_cols(idx, k, -1)


def sharded_hybrid_topk(
    dense_corpus, sketch_corpus, sp_ids: RowSharded, sp_w: RowSharded,
    dense_q, sketch_q, q_ids, q_w, k: int, fetch_k: int, depth: int,
    mask: RowSharded, mesh: Mesh, dense_weight: float = 0.5, sparse_weight: float = 0.5,
    rrf_k: int = 60, exact_topk: bool = True, dense_scale=None, sketch_scale=None,
    rescore_impl: str = "scan", candidate_impl: str = "xla", ft_arm: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The hybrid query over the mesh: per-shard dense and sketch candidates,
    per-shard exact sparse rescore, merges of the shards' pairs, weighted RRF
    on the first device. With ``ft_arm`` = (ft_sketch, ft_ids, ft_w
    [row-sharded], ft_q_proj, ft_q_ids, ft_q_w [replicated], ft_weight,
    ft_scale | None) the BM25 full-text method joins as a third projected arm.

    Returns (fused RRF scores [B, k], rows [B, k]; −1 pads).
    """
    from verbatim_rag_tpu_torch.ops.dense import candidate_topk
    from verbatim_rag_tpu_torch.ops.fusion import rrf_fuse_device
    from verbatim_rag_tpu_torch.ops.hybrid import validate_candidate_impl

    impl = validate_candidate_impl(candidate_impl)
    devices = _devices(mesh, dense_corpus)
    n_local = _n_local(dense_corpus)
    ft_rows = () if ft_arm is None else (ft_arm[0], ft_arm[1], ft_arm[2], ft_arm[7])
    layout = _layout(
        mesh, dense_corpus, sketch_corpus, sp_ids, sp_w, mask, dense_scale, sketch_scale, *ft_rows
    )

    d_scores, d_idx = [], []
    for i, dev in enumerate(devices):
        top, idx = candidate_topk(
            _shard(dense_corpus, i), _replica(dense_q, i, dev), min(fetch_k, n_local),
            _shard(mask, i), _shard(dense_scale, i), exact_topk, impl,
        )
        d_scores.append(top)
        d_idx.append(_globalize(idx, top > NEG_INF / 2, layout.offset(i)))
    d_gs, d_rows = _merge(d_scores, d_idx, fetch_k, layout)
    d_rows = torch.where(d_gs > NEG_INF / 2, d_rows, -1)

    def projected_arm(sketch, ids, w, qproj, qids, qw, sscale):
        scores, rows = [], []
        for i, dev in enumerate(devices):
            top, idx = _projected_arm_local(
                _shard(sketch, i), _shard(ids, i), _shard(w, i), _shard(mask, i),
                _replica(qproj, i, dev), _replica(qids, i, dev), _replica(qw, i, dev),
                _shard(sscale, i), depth, fetch_k, exact_topk, rescore_impl, impl,
                layout.offset(i),
            )
            scores.append(top)
            rows.append(idx)
        top, idx = _merge(scores, rows, fetch_k, layout)
        # A zero exact score (no term overlap) is not a hit.
        return torch.where(top > 0.0, idx, -1)

    arms = [d_rows, projected_arm(sketch_corpus, sp_ids, sp_w, sketch_q, q_ids, q_w, sketch_scale)]
    raw_weights = [dense_weight, sparse_weight]
    if ft_arm is not None:
        ft_sketch, ft_ids, ft_w, ft_qproj, ft_qids, ft_qw, ft_weight, ft_scale = ft_arm
        arms.append(projected_arm(ft_sketch, ft_ids, ft_w, ft_qproj, ft_qids, ft_qw, ft_scale))
        raw_weights.append(ft_weight)
    width = max(a.shape[1] for a in arms)
    stacked = torch.stack([_pad_cols(a, width, -1) for a in arms])
    scores, rows = rrf_fuse_device(
        stacked, _weights(raw_weights, stacked.device), k=min(k, width), rrf_k=rrf_k
    )
    return _pad_cols(scores, k, 0.0), _pad_cols(rows, k, -1)


def sharded_hybrid_section_topk(
    dense_corpus, sketch_corpus, sp_ids: RowSharded, sp_w: RowSharded,
    dense_q, sketch_q, q_ids, q_w, k: int, fetch_k: int, depth: int,
    mask: RowSharded, mesh: Mesh, dense_weight: float = 0.5, sparse_weight: float = 0.5,
    rrf_k: int = 60, dense_scale=None, sketch_scale=None, rescore_impl: str = "pallas",
    ft_arm: tuple | None = None, block_cols: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The mesh-sharded hybrid query with the section tables as each shard's
    candidate stage: one `section_bucket_tables` launch per shard over the
    shard's rows (every arm in it), the shard's table top-ks and exact
    rescores, then the merges of `sharded_hybrid_topk`. The dense arm merges
    by table value (the packed low bits cleared), the projected arms by exact
    score. Each shard's row count must be a ``block_cols`` multiple.

    The TPU program reads column-sharded transposes of the corpora; the
    port's tables read row-major rows, so each shard's row block is exactly
    its share of those transposes. ``ft_arm`` is as in `sharded_hybrid_topk`,
    its sketches row-sharded.

    Returns (fused RRF scores [B, k], rows [B, k]; −1 pads).
    """
    from verbatim_rag_tpu_torch.ops.fusion import rrf_fuse_device
    from verbatim_rag_tpu_torch.ops.hybrid import rescore_fn
    from verbatim_rag_tpu_torch.ops.section import section_bucket_tables, table_topk

    devices = _devices(mesh, dense_corpus)
    n_local = _n_local(dense_corpus)
    corpora = [dense_corpus, sketch_corpus]
    queries = [dense_q, sketch_q]
    scale_list = [dense_scale, sketch_scale]
    arm_index = [(sp_ids, sp_w, q_ids, q_w)]
    raw_weights = [dense_weight, sparse_weight]
    if ft_arm is not None:
        ft_sketch, ft_ids, ft_w, ft_qproj, ft_qids, ft_qw, ft_weight, ft_scale = ft_arm
        corpora.append(ft_sketch)
        queries.append(ft_qproj)
        scale_list.append(ft_scale)
        arm_index.append((ft_ids, ft_w, ft_qids, ft_qw))
        raw_weights.append(ft_weight)
    quantized = any(s is not None for s in scale_list)
    layout = _layout(mesh, *corpora, *scale_list, mask, *(a for arm in arm_index for a in arm[:2]))

    d_vals, d_idx = [], []
    arm_pairs = [([], []) for _ in arm_index]
    for i, dev in enumerate(devices):
        offset = layout.offset(i)
        tables = section_bucket_tables(
            tuple(_shard(c, i) for c in corpora),
            tuple(_replica(q, i, dev) for q in queries),
            _shard(mask, i),
            scales=tuple(_shard(s, i) for s in scale_list) if quantized else (),
            block_cols=block_cols,
        )
        vals, idx = table_topk(tables[0], min(fetch_k, tables[0].shape[1]), block_cols, n_local)
        d_vals.append(vals)
        d_idx.append(_globalize(idx, idx >= 0, offset))
        for (ids, w, qi, qv), table, (scores, rows) in zip(arm_index, tables[1:], arm_pairs):
            local_depth = min(depth, table.shape[1])
            _, cand = table_topk(table, local_depth, block_cols, n_local)
            exact = rescore_fn(rescore_impl)(
                cand.contiguous(), _shard(ids, i), _shard(w, i),
                _replica(qi, i, dev), _replica(qv, i, dev),
            )
            r_top, r_pos = topk(exact, min(fetch_k, local_depth))
            local = torch.gather(cand, 1, r_pos)
            scores.append(r_top)
            rows.append(_globalize(local, r_top > NEG_INF / 2, offset))

    d_gs, d_rows = _merge(d_vals, d_idx, fetch_k, layout)
    arms = [_pad_cols(torch.where(d_gs > NEG_INF / 2, d_rows, -1), fetch_k, -1)]
    for scores, rows in arm_pairs:
        g_s, g_rows = _merge(scores, rows, fetch_k, layout)
        # A zero exact score (no term overlap) is not a hit.
        arms.append(_pad_cols(torch.where(g_s > 0.0, g_rows, -1), fetch_k, -1))
    stacked = torch.stack(arms)
    scores, rows = rrf_fuse_device(
        stacked, _weights(raw_weights, stacked.device), k=min(k, fetch_k), rrf_k=rrf_k
    )
    return _pad_cols(scores, k, 0.0), _pad_cols(rows, k, -1)


def sharded_sparse_topk(
    token_ids: RowSharded, weights: RowSharded, q_dense, k: int, mask: RowSharded,
    mesh: Mesh, block: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed exact forward-index scan (`ops/sparse.py::sparse_scores`
    per shard): (scores [B, k], global rows [B, k]; −1 where the score is not
    above 0)."""
    from verbatim_rag_tpu_torch.ops.sparse import sparse_scores

    layout = _layout(mesh, token_ids, weights, mask)
    scores, rows = [], []
    for i, dev in enumerate(_devices(mesh, token_ids)):
        n_local = token_ids.rows_per_shard
        s = sparse_scores(token_ids.shards[i], weights.shards[i], _replica(q_dense, i, dev), block)
        s = torch.where(mask.shards[i][None, :], s, NEG_INF)
        top, idx = topk(s, min(k, n_local))
        scores.append(top)
        rows.append(idx + layout.offset(i))
    top, idx = _merge(scores, rows, k, layout)
    return top, torch.where(top > 0.0, idx, -1)
