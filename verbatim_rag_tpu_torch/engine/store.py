"""Device-resident hybrid vector store (port of
`verbatim_rag_tpu/engine/store.py`: the bf16 / float32, int8 and int4 tiers,
BM25 full text, the exact sparse mode, compaction, persistence and the
row-sharded mesh store).

Layout on the store's device (a CUDA device unless ``device="cpu"``):

- dense:    ``[cap, d]`` row-normalized bf16 (or f32), or int8 codes with
            a ``[cap, 1]`` float32 scale column (``dense_dtype="int8"``), or
            int4 codes packed two a byte, ``[cap, d/2]`` int8, with the same
            scale column (``dense_dtype="int4"``, `ops/dense.py::Int4Rows`);
- sparse:   forward index ``ids [cap, m]`` int32 (or int16,
            ``sparse_ids_dtype``) + ``weights [cap, m]`` f32 (or f16,
            ``sparse_weight_dtype``), and its projected sketches ``[cap, d_p]`` in the dense family's
            float dtype, or int8 / packed int4 codes with a ``[cap, 1]``
            scale column (``sketch_dtype="int8"`` / ``"int4"``);
- full text (``enable_full_text``): the same forward-index layout over a
            hashed analyzer vocabulary (`engine/analyzer.py`): term ids and
            raw term frequencies ``[cap, fm]`` int32, their BM25-saturated
            weights ``[cap, fm]`` f32, and projected BM25 sketches; document
            lengths and document frequencies stay on the host;
- validity: ``[cap] bool`` — deletes flip it (tombstones); `compact`
            rebuilds the arrays without them.

The dense and sketch matrices (and their int8 / int4 codes) are ``[cap, d]``
views of buffers whose rows start a 16-byte multiple apart
(`ops/fused_topk.py::pitched_zeros`: 304 bytes for 300 int8 columns), so the
table kernels read rows of any width in place, through TMA, without a copy
per query; every other op reads the views as any tensor. Saved files hold
``[n, d]``, as the JAX store writes them.

Text and metadata stay on the host. Writes queue in a host buffer; `flush()`
writes them into the device arrays, whose capacity grows geometrically from
``block``. Unlike the JAX store (immutable arrays, a fresh buffer per
write), rows are written in place into the preallocated arrays.

With a ``mesh`` (`parallel/mesh.py`) every device array is row-sharded over
the mesh's devices (`RowSharded`, dp-major, ``block`` a multiple of the mesh
size), and re-placed whole when capacity grows; queries run through
`parallel/sharded_search.py`, each kernel once per shard, and the shards'
results merge on the mesh's first device, which is the store's ``device``.

Queries: each method alone (dense, sparse, full text), and the hybrids.
Dense + sparse, with or without full text, runs as one call per batch on the
projected tier: candidate selection, exact rescores (the CUDA kernel on the
default ``rescore_impl="pallas"``) and weighted RRF, then one [B, k]
readback. Candidate selection follows ``candidate_impl``: "xla" scores the
[B, N] matrices and selects exactly (`ops/hybrid.py::hybrid_fused_topk`,
`hybrid_fused_topk_3way`); "section" (what "auto" picks on the int8 tier)
builds every arm's packed bucket tables in one kernel launch
(`ops/section.py::hybrid_section_topk`, `hybrid_section_topk_3way`);
"bucket" runs the fused bucket-max kernel per arm (`ops/fused_topk.py`).
``sparse_mode="exact"`` scores the sparse and full-text methods by scanning
every forward-index row (`ops/sparse.py::sparse_topk`) and fuses methods on
the host.

`save` writes ``<path>.npz`` + ``<path>.json`` in the JAX store's format, so
an index saved by either package loads in the other; ``load(path, mesh=...)``
shards it at load time (placement is never persisted).
"""

from __future__ import annotations

import functools
import json
import logging
import os
from abc import ABC, abstractmethod
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from verbatim_rag_tpu_torch.device import resolve_device
from verbatim_rag_tpu_torch.utils import profiling

from .analyzer import analyze_texts
from .filters import PROMOTED_FIELDS, FilterSpec, compile_filter, stable_hash64
from .search_result import SearchResult

logger = logging.getLogger(__name__)

_BLOCK = 8192
_FLUSH_PAD = 1024


class VectorStore(ABC):
    """Abstract store contract."""

    @abstractmethod
    def add_vectors(self, records: list[dict[str, Any]]) -> None:
        """Insert records: {id, text, enhanced_text, metadata, dense?, sparse?}."""

    @abstractmethod
    def query(self, **kwargs) -> list[SearchResult]:
        """Search; see DeviceVectorStore.query for the full parameter set."""

    @abstractmethod
    def delete(self, ids: list[str]) -> None:
        """Remove records by id."""


def json_safe(value):
    """``json.dump`` default for metadata payloads (datetimes, enums, sets,
    numpy scalars)."""
    import datetime
    import enum

    if isinstance(value, (datetime.date, datetime.datetime)):
        return value.isoformat()
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (set, frozenset)):
        return sorted(value)
    if isinstance(value, np.generic):
        return value.item()
    return str(value)


def _pad_sparse(
    entries: Mapping[int, float] | Sequence[tuple[int, float]],
    max_nnz: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a sparse vector to fixed width, keeping the heaviest terms."""
    items = list(entries.items()) if isinstance(entries, Mapping) else list(entries)
    items = [(int(t), float(w)) for t, w in items if w != 0.0]
    if len(items) > max_nnz:
        items.sort(key=lambda tw: -abs(tw[1]))
        items = items[:max_nnz]
    ids = np.zeros(max_nnz, np.int32)
    weights = np.zeros(max_nnz, np.float32)
    for j, (t, w) in enumerate(items):
        ids[j] = t
        weights[j] = w
    return ids, weights


def _nonzero_first(ids: np.ndarray, weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Forward-index rows [n, m] with each row's nonzero weights moved to the
    front in their order and the pads after them (id 0, weight 0): what
    `_pad_sparse` makes of the row's ``{id: weight}`` dict at width m."""
    order = np.argsort(weights == 0, axis=1, kind="stable")
    w = np.take_along_axis(weights, order, axis=1).astype(np.float32)
    ids = np.where(w != 0, np.take_along_axis(ids, order, axis=1), 0).astype(np.int32)
    return ids, w


def _is_sparse_arrays(payload) -> bool:
    """True when a sparse query payload is an ``(ids, weights)`` array pair
    rather than a sequence of term→weight mappings."""
    return (
        isinstance(payload, tuple)
        and len(payload) == 2
        and not isinstance(payload[0], Mapping)
        and getattr(payload[0], "ndim", None) == 2
    )


#: Device dtype of each tier; int4 codes are packed two a byte into int8.
_STORE_DTYPES = {
    "bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8, "int4": torch.int8,
}


class DeviceVectorStore(VectorStore):
    """The device-resident hybrid index."""

    #: records may carry ``sparse_arrays`` = (ids int32 [m], weights f32 [m])
    #: instead of a ``sparse`` dict.
    accepts_sparse_arrays = True
    #: query_batch accepts tensor dense queries and (ids, w) sparse arrays.
    accepts_query_arrays = True

    def __init__(
        self,
        dense_dim: int | None = 384,
        sparse_vocab: int | None = 30522,
        sparse_max_nnz: int = 128,
        enable_full_text: bool = False,
        full_text_vocab: int = 1 << 17,
        full_text_max_nnz: int = 256,
        dense_dtype: str = "bfloat16",
        sketch_dtype: str | None = None,
        block: int = _BLOCK,
        bm25_k1: float = 1.2,
        bm25_b: float = 0.75,
        sparse_mode: str = "projected",
        projection_dim: int = 768,
        rescore_depth: int = 256,
        projection_seed: int = 0,
        mesh=None,
        approx_topk: bool = True,
        auto_compact_threshold: float | None = None,
        allow_exact_at_scale: bool = False,
        rescore_impl: str = "pallas",
        candidate_impl: str = "auto",
        sparse_weight_dtype: str = "float32",
        sparse_ids_dtype: str = "int32",
        device=None,
    ):
        if sparse_mode not in ("projected", "exact"):
            raise ValueError(f"sparse_mode must be 'projected' or 'exact', got {sparse_mode!r}")
        if rescore_impl not in ("scan", "oneshot", "pallas"):
            raise ValueError(
                f"rescore_impl must be 'scan', 'oneshot' or 'pallas', got {rescore_impl!r}"
            )
        from verbatim_rag_tpu_torch.ops.hybrid import validate_candidate_impl

        if "," in candidate_impl:
            # 0.4.x persisted per-stage comma-pair specs ("dense,sketch"
            # splits like "bucket,xla"); indexes saved under them stay
            # loadable. A valid legacy pair maps to "xla", as in the JAX
            # store; junk specs still fail like any other typo.
            parts = candidate_impl.split(",")
            if len(parts) != 2 or any(p not in ("xla", "bucket") for p in parts):
                raise ValueError(
                    f"candidate_impl {candidate_impl!r} is not a valid spec "
                    "(the 0.4.x comma-pair format held exactly two of "
                    "'xla'/'bucket')"
                )
            logger.warning(
                "candidate_impl=%r is the retired 0.4.x per-stage comma-pair "
                "spec; using 'xla' (the measured composition winner). "
                "Re-save the index to persist the new spec.",
                candidate_impl,
            )
            candidate_impl = "xla"
        #: The spec as passed, after the comma-pair mapping and before "auto"
        #: resolves (the JAX store persists it so a reload re-resolves).
        self.candidate_impl_requested = candidate_impl
        if candidate_impl == "auto":
            # The JAX package's policy: the section kernel serves the int8
            # tier (both matrices int8) when the store selects approximately;
            # int4 stores, mesh stores (the per-shard section path is opt-in
            # until measured on multi-chip hardware) and a store built for
            # exact selection take the "xla" program.
            candidate_impl = (
                "section"
                if dense_dtype == "int8"
                and sketch_dtype == "int8"
                and mesh is None
                and approx_topk
                else "xla"
            )
        if candidate_impl == "section":
            if dense_dtype == "int4" or sketch_dtype == "int4":
                raise ValueError(
                    "candidate_impl='section' does not serve the int4 tier "
                    "(the section kernel streams int8/bf16 blocks; no packed "
                    "4-bit unpack) — use 'xla' for int4 stores"
                )
            if mesh is not None and block % (mesh.size * 8192) != 0:
                raise ValueError(
                    "candidate_impl='section' on a mesh needs each shard's "
                    "capacity to tile the kernel's 8192-column grid: pass "
                    f"block as a multiple of mesh.size*8192 ({mesh.size * 8192}), "
                    f"got block={block}"
                )
        else:
            validate_candidate_impl(candidate_impl)
        if dense_dtype not in ("bfloat16", "float32", "int8", "int4"):
            raise ValueError(
                "dense_dtype must be 'bfloat16', 'float32', 'int8' or 'int4', "
                f"got {dense_dtype!r}"
            )
        if sketch_dtype not in (None, "bfloat16", "float32", "int8", "int4"):
            raise ValueError(
                "sketch_dtype must be None, 'bfloat16', 'float32', 'int8' or "
                f"'int4', got {sketch_dtype!r}"
            )
        if dense_dtype == "int4" and dense_dim % 2:
            raise ValueError("int4 dense packing needs an even dense_dim")
        if sketch_dtype == "int4" and projection_dim % 2:
            raise ValueError("int4 sketch packing needs an even projection_dim")
        if sparse_weight_dtype not in ("float32", "float16"):
            raise ValueError(
                "sparse_weight_dtype must be 'float32' or 'float16', "
                f"got {sparse_weight_dtype!r}"
            )
        if sparse_ids_dtype not in ("int32", "int16"):
            raise ValueError(
                f"sparse_ids_dtype must be 'int32' or 'int16', got {sparse_ids_dtype!r}"
            )
        if sparse_ids_dtype == "int16" and sparse_vocab is not None and sparse_vocab > 32768:
            raise ValueError(
                f"sparse_ids_dtype='int16' holds vocab ids < 32768; "
                f"sparse_vocab is {sparse_vocab}"
            )
        if mesh is not None and block % mesh.size != 0:
            raise ValueError(
                f"block ({block}) must be a multiple of the mesh size ({mesh.size}) "
                "so index rows shard evenly"
            )
        if sparse_mode == "exact":
            logger.warning(
                "sparse_mode='exact' scans every forward-index row per query — "
                "correct, but far slower than 'projected' at large N. Intended "
                "for validation runs."
            )
        #: Optional `parallel.Mesh`: every device array is row-sharded over
        #: its devices and queries run through `parallel/sharded_search.py`.
        #: The store's ``device`` is then the mesh's first device (queries
        #: land and merge there); a ``device`` of another type raises.
        self.mesh = mesh
        self.device = self._store_device(device, mesh)
        self.dense_dim = dense_dim
        self.sparse_vocab = sparse_vocab
        self.sparse_max_nnz = sparse_max_nnz
        self.enable_full_text = enable_full_text
        self.full_text_vocab = full_text_vocab
        self.full_text_max_nnz = full_text_max_nnz
        self.dense_dtype = dense_dtype
        self.sketch_dtype = sketch_dtype
        self.block = block
        self.bm25_k1 = bm25_k1
        self.bm25_b = bm25_b
        self.sparse_mode = sparse_mode
        self.projection_dim = projection_dim
        self.rescore_depth = rescore_depth
        self.projection_seed = projection_seed
        #: Forward-index storage: "int16" ids (vocab ≤ 32768) and "float16"
        #: weights each halve their half of the index; the rescore widens them.
        self.sparse_ids_dtype = sparse_ids_dtype
        self.sparse_weight_dtype = sparse_weight_dtype
        #: Candidate selection the store asks for. Selection over score
        #: matrices is exact here either way (lowest index first among ties);
        #: approx_topk=True lets the approximate bucket-table impls
        #: ("section", "bucket") serve, False sends every query to the exact
        #: "xla" program. Per-query override: search_params["approx_topk"].
        self.approx_topk = approx_topk
        #: When set, `delete` compacts once the dead fraction reaches it.
        self.auto_compact_threshold = auto_compact_threshold
        #: Lets the exact sparse scan run above `EXACT_SCAN_MAX_ROWS` rows.
        self.allow_exact_at_scale = allow_exact_at_scale
        self.rescore_impl = rescore_impl
        #: "xla", "section" or "bucket" (resolved from "auto" above).
        self.candidate_impl = candidate_impl
        self._warned_section_fallback: set[str] = set()

        # Host-side record state.
        self._ids: list[str] = []
        self._row_of: dict[str, int] = {}
        self._texts: list[str] = []
        self._enhanced: list[str] = []
        self._metadata: list[dict] = []
        self._valid = np.zeros(0, dtype=bool)
        self._promoted: dict[str, np.ndarray] = {
            f: np.zeros(0, dtype=np.int64) for f in PROMOTED_FIELDS
        }

        self._pending: list[dict[str, Any]] = []
        self._pending_ids: set[str] = set()

        # Device arrays (allocated on first flush).
        self._dense = None  # [cap, d] (int8 codes when dense_dtype="int8")
        self._dense_scale = None  # [cap, 1] f32 per-row scales (int8 only)
        self._sp_ids = None  # [cap, m] int32 or int16
        self._sp_w = None  # [cap, m] f32 or f16
        self._sp_proj = None  # [cap, d_p] projected sparse sketches
        self._sp_proj_scale = None  # [cap, 1] f32 per-row scales (int8 only)
        self._ft_ids = None  # [cap, fm] int32 analyzer slots
        self._ft_tf = None  # [cap, fm] int32 raw term frequencies
        self._ft_w = None  # [cap, fm] f32 BM25-saturated weights
        self._ft_proj = None  # [cap, d_p] projected BM25 sketches
        self._ft_proj_scale = None  # [cap, 1] f32 per-row scales (int8 only)
        self._valid_dev = None  # [cap] bool
        self._capacity = 0

        # Full-text corpus statistics (host).
        self._doc_len = np.zeros(0, dtype=np.float32)
        self._doc_freq = (
            np.zeros(full_text_vocab, dtype=np.int64) if enable_full_text else None
        )

    @staticmethod
    def _store_device(device, mesh) -> torch.device:
        if mesh is None:
            return resolve_device(device)
        first = mesh.flat_devices[0]
        if device is not None and torch.device(device).type != first.type:
            raise ValueError(
                f"device={device!r} differs from the mesh's devices ({first.type}); "
                "a mesh store lives on its mesh"
            )
        return first

    # -- basic accessors -----------------------------------------------------

    @property
    def _dense_store_dtype(self) -> torch.dtype:
        """Device dtype of the dense matrix. ``int8`` is the capacity mode:
        per-row symmetric codes (`ops/dense.py::quantize_rows_int8`) with a
        float32 scale column, half the bytes of bf16; ``int4`` packs codes in
        [-7, 7] two a byte (`quantize_rows_int4`), a quarter."""
        return _STORE_DTYPES[self.dense_dtype]

    @property
    def _dense_quantized(self) -> bool:
        return self.dense_dtype in ("int8", "int4")

    @property
    def _sketch_quantized(self) -> bool:
        return self.sketch_dtype in ("int8", "int4")

    @property
    def _dense_width(self) -> int:
        """Stored column count of the dense matrix (int4 packs pairs)."""
        return self.dense_dim // 2 if self.dense_dtype == "int4" else self.dense_dim

    @property
    def _sketch_width(self) -> int:
        """Stored column count of the sketch matrices (int4 packs pairs)."""
        return self.projection_dim // 2 if self.sketch_dtype == "int4" else self.projection_dim

    def _dense_scoring_args(self):
        """(corpus, scale) as the query programs take them: int4 codes travel
        in the `Int4Rows` carrier with their scales, never as bare int8."""
        if self.dense_dtype == "int4":
            from verbatim_rag_tpu_torch.ops.dense import Int4Rows

            return Int4Rows(self._dense, self._dense_scale), None
        return self._dense, self._dense_scale

    def _sketch_scoring_args(self, proj, scale):
        """The same wrap for a sketch matrix (SPLADE or BM25)."""
        if self.sketch_dtype == "int4":
            from verbatim_rag_tpu_torch.ops.dense import Int4Rows

            return Int4Rows(proj, scale), None
        return proj, scale

    @property
    def _sketch_store_dtype(self) -> torch.dtype:
        """Explicit ``sketch_dtype`` wins; otherwise sketches follow the
        dense matrix's float family."""
        if self.sketch_dtype is not None:
            return _STORE_DTYPES[self.sketch_dtype]
        return torch.float32 if self.dense_dtype == "float32" else torch.bfloat16

    @property
    def _sp_ids_dtype(self) -> torch.dtype:
        return torch.int16 if self.sparse_ids_dtype == "int16" else torch.int32

    @property
    def _sp_w_dtype(self) -> torch.dtype:
        """float32 → float16 rounds to nearest even, as numpy's cast in the
        JAX store does."""
        return torch.float16 if self.sparse_weight_dtype == "float16" else torch.float32

    @property
    def _per_stage_candidate_impl(self) -> str:
        """"section" is a whole-program impl (both hybrid arms in one
        launch); single-method queries take the stage-wise "xla" instead."""
        return "xla" if self.candidate_impl == "section" else self.candidate_impl

    @property
    def size(self) -> int:
        """Number of rows ever inserted (including tombstones/pending)."""
        return len(self._ids) + len(self._pending)

    def count(self) -> int:
        """Number of live records."""
        live = int(self._valid.sum()) if self._valid.size else 0
        return live + len(self._pending)

    # -- ingest ----------------------------------------------------------------

    def add_vectors(self, records: list[dict[str, Any]]) -> None:
        """Queue records for insertion (the whole batch is validated first).

        Record keys: ``id`` (str), ``text``, ``enhanced_text``, ``metadata``
        (dict), ``dense`` (array [d] or None), ``sparse`` (dict token→weight)
        or ``sparse_arrays`` (ids, weights).
        """
        seen: set[str] = set()
        for rec in records:
            rid = rec["id"]
            if rid in self._row_of or rid in self._pending_ids or rid in seen:
                raise ValueError(f"Duplicate id: {rid}")
            seen.add(rid)
        for rec in records:
            self._pending.append(rec)
            self._pending_ids.add(rec["id"])

    def flush(self) -> None:
        """Write pending records into the device arrays (and refresh the
        BM25 weights when a `reserve` left them stale)."""
        if not self._pending:
            if self.enable_full_text and self._bm25_stale:
                self._recompute_bm25()
            return
        pending, self._pending = self._pending, []
        self._pending_ids.clear()
        n_new = len(pending)
        offset = len(self._ids)

        dense_new = (
            np.zeros((n_new, self.dense_dim), np.float32) if self.dense_dim else None
        )
        sp_ids_new = (
            np.zeros((n_new, self.sparse_max_nnz), np.int32) if self.sparse_vocab else None
        )
        sp_w_new = (
            np.zeros((n_new, self.sparse_max_nnz), np.float32) if self.sparse_vocab else None
        )

        for i, rec in enumerate(pending):
            self._ids.append(rec["id"])
            self._row_of[rec["id"]] = offset + i
            self._texts.append(rec.get("text", ""))
            self._enhanced.append(rec.get("enhanced_text", ""))
            self._metadata.append(rec.get("metadata", {}) or {})

            if dense_new is not None and rec.get("dense") is not None:
                vec = np.asarray(rec["dense"], np.float32)
                norm = np.linalg.norm(vec)
                dense_new[i] = vec / norm if norm > 0 else vec
            if sp_ids_new is not None and rec.get("sparse_arrays") is not None:
                row_ids, row_w = rec["sparse_arrays"]
                if len(row_ids) > self.sparse_max_nnz:
                    # Keep the heaviest terms regardless of provider row order.
                    top = np.argpartition(-np.abs(row_w), self.sparse_max_nnz - 1)[
                        : self.sparse_max_nnz
                    ]
                    row_ids, row_w = row_ids[top], row_w[top]
                m = len(row_ids)
                sp_ids_new[i, :m] = row_ids
                sp_w_new[i, :m] = row_w
            elif sp_ids_new is not None and rec.get("sparse") is not None:
                sp_ids_new[i], sp_w_new[i] = _pad_sparse(rec["sparse"], self.sparse_max_nnz)
        if self.enable_full_text:
            ft_ids_new, ft_tf_new, dl_new = self._full_text_rows(
                [rec.get("text", "") for rec in pending]
            )
            self._doc_freq += np.bincount(
                ft_ids_new[ft_tf_new > 0], minlength=self.full_text_vocab
            )
        else:
            dl_new = np.zeros(n_new, np.float32)

        # Host columnar state.
        self._valid = np.concatenate([self._valid, np.ones(n_new, bool)])
        for f in PROMOTED_FIELDS:
            col = np.fromiter(
                (
                    stable_hash64(m.get(f)) if m.get(f) is not None else np.int64(0)
                    for m in self._metadata[offset:]
                ),
                dtype=np.int64,
                count=n_new,
            )
            self._promoted[f] = np.concatenate([self._promoted[f], col])
        self._doc_len = np.concatenate([self._doc_len, dl_new])

        # Capacity grows as in the JAX store, which sizes for the new rows
        # padded to a fixed row chunk.
        pad_unit = min(_FLUSH_PAD, self.block)
        pad_rows = -(-n_new // pad_unit) * pad_unit
        new_cap = self._target_capacity(offset + pad_rows, first_flush=offset == 0)

        def _write(arr, new_rows, width, dtype, pitched=False):
            arr = self._grow_capacity(arr, new_cap, width, dtype, pitched)
            arr[offset : offset + n_new] = torch.as_tensor(new_rows).to(self.device, dtype)
            return arr

        def _quantize(rows, dtype: str):
            """(codes, scales) of rows on the int8 or int4 tier."""
            from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int4, quantize_rows_int8

            return (quantize_rows_int4 if dtype == "int4" else quantize_rows_int8)(rows)

        def _write_sketch(arr, scale_arr, proj_new):
            """Write a sketch matrix's new rows (codes and their scale column
            on the int8 and int4 tiers)."""
            if self._sketch_quantized:
                codes, scale = _quantize(proj_new, self.sketch_dtype)
                return (
                    _write(arr, codes, self._sketch_width, torch.int8, pitched=True),
                    _write(scale_arr, scale, 1, torch.float32),
                )
            sketch = _write(arr, proj_new, self.projection_dim, self._sketch_store_dtype, pitched=True)
            return sketch, scale_arr

        if dense_new is not None:
            if self._dense_quantized:
                codes, scale = _quantize(torch.from_numpy(dense_new).to(self.device), self.dense_dtype)
                self._dense = _write(self._dense, codes, self._dense_width, torch.int8, pitched=True)
                self._dense_scale = _write(self._dense_scale, scale, 1, torch.float32)
            else:
                self._dense = _write(
                    self._dense, dense_new, self.dense_dim, self._dense_store_dtype, pitched=True
                )
        if sp_ids_new is not None:
            from verbatim_rag_tpu_torch.ops.sparse_projected import project_rows

            ids_dev = torch.from_numpy(sp_ids_new).to(self.device)
            w_dev = torch.from_numpy(sp_w_new).to(self.device)
            self._sp_ids = _write(self._sp_ids, ids_dev, self.sparse_max_nnz, self._sp_ids_dtype)
            self._sp_w = _write(self._sp_w, w_dev, self.sparse_max_nnz, self._sp_w_dtype)
            if self.sparse_mode == "projected":
                # Sketch the new rows on the device from their float32 weights
                # (the JAX store sketches before any float16 rounding).
                proj_new = project_rows(ids_dev, w_dev, self._projection_dev(self.sparse_vocab))
                self._sp_proj, self._sp_proj_scale = _write_sketch(
                    self._sp_proj, self._sp_proj_scale, proj_new
                )
        if self.enable_full_text:
            fm = self.full_text_max_nnz
            self._ft_ids = _write(self._ft_ids, ft_ids_new, fm, torch.int32)
            self._ft_tf = _write(self._ft_tf, ft_tf_new, fm, torch.int32)
            self._recompute_bm25()
            if self.sparse_mode == "projected":
                from verbatim_rag_tpu_torch.ops.sparse_projected import project_rows

                # New rows are sketched with the current avgdl's saturation,
                # computed on the host as the JAX store does; older sketches
                # go stale as avgdl drifts, which only moves candidate
                # selection (the rescore reads the fresh weights). `load` and
                # `compact` rebuild every sketch in one flush.
                n = len(self._ids)
                avgdl = max(float(self._doc_len[:n].mean()) if n else 1.0, 1.0)
                tf_new = ft_tf_new.astype(np.float32)
                norm = self.bm25_k1 * (
                    1.0 - self.bm25_b + self.bm25_b * dl_new[:, None] / avgdl
                )
                sat_new = np.where(
                    tf_new > 0, tf_new * (self.bm25_k1 + 1.0) / (tf_new + norm), 0.0
                ).astype(np.float32)
                proj_new = project_rows(
                    torch.from_numpy(ft_ids_new).to(self.device),
                    torch.from_numpy(sat_new).to(self.device),
                    self._projection_dev(self.full_text_vocab),
                )
                self._ft_proj, self._ft_proj_scale = _write_sketch(
                    self._ft_proj, self._ft_proj_scale, proj_new
                )

        self._set_valid_dev(new_cap)
        self._capacity = new_cap

    def _full_text_rows(self, texts: Sequence[str]):
        """The forward-index rows of ``texts``: (slots [n, fm] int32, raw
        term frequencies [n, fm] int32, document lengths [n] float32).

        A text with more than ``full_text_max_nnz`` unique terms keeps the
        heaviest, picked as the JAX store picks them (``np.argsort(-tfs)``
        over the analyzer's first-occurrence order, so ties resolve alike)."""
        fm = self.full_text_max_nnz
        slots, counts, offsets, lengths = analyze_texts(texts, self.full_text_vocab)
        n = len(texts)
        ft_ids = np.zeros((n, fm), np.int32)
        ft_tf = np.zeros((n, fm), np.int32)
        unique = np.diff(offsets)
        doc = np.repeat(np.arange(n), unique)
        col = np.arange(slots.size) - offsets[doc]
        fits = unique[doc] <= fm
        ft_ids[doc[fits], col[fits]] = slots[fits]
        ft_tf[doc[fits], col[fits]] = counts[fits]
        for i in np.flatnonzero(unique > fm):
            terms, tfs = slots[offsets[i] : offsets[i + 1]], counts[offsets[i] : offsets[i + 1]]
            top = np.argsort(-tfs)[:fm]
            ft_ids[i], ft_tf[i] = terms[top], tfs[top]
        return ft_ids, ft_tf, lengths.astype(np.float32)

    def _set_valid_dev(self, cap: int) -> None:
        valid = torch.zeros(cap, dtype=torch.bool)
        valid[: self._valid.size] = torch.from_numpy(self._valid)
        self._valid_dev = self._place(valid.to(self.device))

    def _place(self, arr: torch.Tensor):
        """Row-shard an array over the mesh (as it is without one)."""
        if self.mesh is None:
            return arr
        from verbatim_rag_tpu_torch.parallel.mesh import row_sharding

        return row_sharding(arr, self.mesh)

    def _per_shard(self, fn, *arrays):
        """``fn`` of row-aligned arrays, shard by shard on a mesh."""
        if self.mesh is None:
            return fn(*arrays)
        return arrays[0].map(fn, *arrays[1:])

    def _target_capacity(self, needed: int, first_flush: bool = False) -> int:
        """Next capacity: doubles from `block`. The first flush of an empty
        store sizes tightly (next block multiple, never below a `reserve`)."""
        if first_flush:
            return max(-(-needed // self.block) * self.block, self.block, self._capacity)
        cap = max(self._capacity, self.block)
        while cap < needed:
            cap *= 2
        return cap

    def _grow_capacity(self, old, cap: int, width: int, dtype, pitched: bool = False):
        """Allocate [cap, width] zeros and copy the old rows into the prefix;
        ``pitched`` (the dense and sketch matrices) at a 16-byte row pitch.

        On a mesh each shard's row range moves with the capacity, so the old
        rows are re-placed, shard by shard, into the new array's shards."""
        from verbatim_rag_tpu_torch.ops.fused_topk import pitched_zeros

        if old is not None and old.shape[0] >= cap:
            return old

        def zeros(rows, device):
            if pitched:
                return pitched_zeros(rows, width, dtype, device)
            return torch.zeros((rows, width), dtype=dtype, device=device)

        if self.mesh is None:
            fresh = zeros(cap, self.device)
            if old is not None:
                fresh[: old.shape[0]] = old
            return fresh
        from verbatim_rag_tpu_torch.parallel.mesh import RowSharded

        m = cap // self.mesh.size
        fresh = RowSharded([zeros(m, d) for d in self.mesh.flat_devices])
        if old is not None:
            for i, shard in enumerate(old.shards):
                fresh[i * old.rows_per_shard : (i + 1) * old.rows_per_shard] = shard
        return fresh

    @property
    def _bm25_stale(self) -> bool:
        return self._ft_w is None and self._ft_tf is not None

    def _recompute_bm25(self) -> None:
        """Saturate every row's term frequencies at the current avgdl (which
        counts tombstoned rows, as the JAX store's does)."""
        from verbatim_rag_tpu_torch.ops.sparse import bm25_saturate

        n = len(self._ids)
        avgdl = max(float(self._doc_len[:n].mean()) if n else 1.0, 1.0)
        dl_padded = np.zeros(int(self._ft_tf.shape[0]), np.float32)
        dl_padded[:n] = self._doc_len[:n]
        self._ft_w = self._per_shard(
            lambda tf, dl: bm25_saturate(
                tf, dl, torch.tensor(avgdl, dtype=torch.float32, device=tf.device),
                k1=self.bm25_k1, b=self.bm25_b,
            ),
            self._ft_tf,
            self._place(torch.from_numpy(dl_padded).to(self.device)),
        )

    def _dense_rows_f32(self, n: int) -> np.ndarray:
        """Host float32 copy of the first ``n`` dense rows (dequantized)."""
        rows = self._dense[:n]
        if self.dense_dtype == "int4":
            from verbatim_rag_tpu_torch.ops.dense import unpack_int4

            rows = unpack_int4(rows)
        rows = rows.float().cpu().numpy()
        if self._dense_quantized:
            rows = rows * self._dense_scale[:n].cpu().numpy()
        return rows

    # -- projections ---------------------------------------------------------------

    _projection_cache: dict = {}

    def _projection(self, vocab: int) -> np.ndarray:
        key = (vocab, self.projection_dim, self.projection_seed)
        if key not in DeviceVectorStore._projection_cache:
            from verbatim_rag_tpu_torch.ops.sparse_projected import projection_matrix

            DeviceVectorStore._projection_cache[key] = projection_matrix(
                vocab, self.projection_dim, self.projection_seed
            )
        return DeviceVectorStore._projection_cache[key]

    _projection_dev_cache: dict = {}

    def _projection_dev(self, vocab: int) -> torch.Tensor:
        """Device copy of the projection matrix, shared per (vocab, d_p,
        seed, device)."""
        key = (vocab, self.projection_dim, self.projection_seed, str(self.device))
        if key not in DeviceVectorStore._projection_dev_cache:
            DeviceVectorStore._projection_dev_cache[key] = torch.from_numpy(
                self._projection(vocab)
            ).to(self.device)
        return DeviceVectorStore._projection_dev_cache[key]

    # -- deletes and housekeeping ------------------------------------------------------

    def delete(self, ids: list[str]) -> None:
        """Tombstone rows: flip the validity mask (host and device). Full
        text: each newly deleted row's terms leave the document frequencies
        (re-analyzed from its text, cut as at ingest), so idf stays that of
        the live rows. With ``auto_compact_threshold`` set, compact once the
        dead fraction reaches it."""
        self.flush()
        rows = [self._row_of[i] for i in ids if i in self._row_of]
        if not rows:
            return
        if self.enable_full_text and self._doc_freq is not None:
            live = sorted({r for r in rows if self._valid[r]})
            ft_ids, ft_tf, _ = self._full_text_rows([self._texts[r] for r in live])
            self._doc_freq -= np.bincount(ft_ids[ft_tf > 0], minlength=self.full_text_vocab)
        self._valid[rows] = False
        if self._valid_dev is not None:
            self._valid_dev[torch.as_tensor(rows, device=self.device)] = False
        if self.auto_compact_threshold is not None:
            n = len(self._ids)
            dead = n - int(self._valid[:n].sum())
            if n and dead / n >= self.auto_compact_threshold:
                reclaimed = self.compact()
                logger.info("auto-compacted %d tombstoned rows", reclaimed)

    def delete_document(self, document_id: str) -> None:
        self.flush()
        rows = [
            i
            for i, m in enumerate(self._metadata)
            if m.get("document_id") == document_id and self._valid[i]
        ]
        self.delete([self._ids[r] for r in rows])

    def reserve(self, n_rows: int) -> None:
        """Pre-size device capacity for a known corpus size: one allocation
        instead of log2(n) growth copies during a large ingest."""
        if n_rows <= self._capacity:
            return
        self.flush()
        cap = max(-(-n_rows // self.block) * self.block, self.block)
        grow = self._grow_capacity
        if self.dense_dim:
            self._dense = grow(
                self._dense, cap, self._dense_width, self._dense_store_dtype, pitched=True
            )
            if self._dense_quantized:
                self._dense_scale = grow(self._dense_scale, cap, 1, torch.float32)
        sketches = []
        if self.sparse_vocab:
            self._sp_ids = grow(self._sp_ids, cap, self.sparse_max_nnz, self._sp_ids_dtype)
            self._sp_w = grow(self._sp_w, cap, self.sparse_max_nnz, self._sp_w_dtype)
            sketches.append(("_sp_proj", "_sp_proj_scale"))
        if self.enable_full_text:
            self._ft_ids = grow(self._ft_ids, cap, self.full_text_max_nnz, torch.int32)
            self._ft_tf = grow(self._ft_tf, cap, self.full_text_max_nnz, torch.int32)
            sketches.append(("_ft_proj", "_ft_proj_scale"))
            self._ft_w = None  # recomputed at the next flush, at this capacity
        if self.sparse_mode == "projected":
            for proj, scale in sketches:
                setattr(self, proj, grow(
                    getattr(self, proj), cap, self._sketch_width, self._sketch_store_dtype,
                    pitched=True,
                ))
                if self._sketch_quantized:
                    setattr(self, scale, grow(getattr(self, scale), cap, 1, torch.float32))
        self._set_valid_dev(cap)
        self._capacity = cap

    def _config(self) -> dict[str, Any]:
        """The constructor arguments `save` persists (the JAX store's keys,
        in its order: a file either package writes loads in the other)."""
        return {
            "dense_dim": self.dense_dim,
            "sparse_vocab": self.sparse_vocab,
            "sparse_max_nnz": self.sparse_max_nnz,
            "enable_full_text": self.enable_full_text,
            "full_text_vocab": self.full_text_vocab,
            "full_text_max_nnz": self.full_text_max_nnz,
            "dense_dtype": self.dense_dtype,
            "sketch_dtype": self.sketch_dtype,
            "block": self.block,
            "sparse_mode": self.sparse_mode,
            "projection_dim": self.projection_dim,
            "rescore_depth": self.rescore_depth,
            "projection_seed": self.projection_seed,
            "approx_topk": self.approx_topk,
            "auto_compact_threshold": self.auto_compact_threshold,
            "allow_exact_at_scale": self.allow_exact_at_scale,
            "rescore_impl": self.rescore_impl,
            "candidate_impl": self.candidate_impl_requested,
            "sparse_weight_dtype": self.sparse_weight_dtype,
            "sparse_ids_dtype": self.sparse_ids_dtype,
        }

    def compact(self, min_dead_fraction: float = 0.0) -> int:
        """Reclaim tombstoned rows by rebuilding the arrays from the live
        rows in one flush (dense rows dequantized, forward-index rows with
        their nonzero terms first, as the JAX store's term dicts pad them;
        full text re-analyzed). Returns the rows reclaimed."""
        self.flush()
        n = len(self._ids)
        dead = n - int(self._valid[:n].sum())
        if n == 0 or dead == 0 or dead / n < min_dead_fraction:
            return 0

        keep = np.flatnonzero(self._valid[:n])
        sp_rows = None
        if self._sp_ids is not None:
            sp_rows = _nonzero_first(self._sp_ids[:n].cpu().numpy(), self._sp_w[:n].cpu().numpy())
        dense_np = self._dense_rows_f32(n) if self._dense is not None else None
        records = []
        for row in keep:
            rec: dict[str, Any] = {
                "id": self._ids[row],
                "text": self._texts[row],
                "enhanced_text": self._enhanced[row],
                "metadata": self._metadata[row],
            }
            if dense_np is not None:
                rec["dense"] = dense_np[row]
            if sp_rows is not None:
                rec["sparse_arrays"] = (sp_rows[0][row], sp_rows[1][row])
            records.append(rec)

        fresh = DeviceVectorStore(**self._config(), mesh=self.mesh, device=self.device)
        fresh.add_vectors(records)
        fresh.flush()
        self.__dict__.update(fresh.__dict__)
        return dead

    # -- persistence ---------------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist to ``<path>.npz`` + ``<path>.json`` in the JAX store's
        format: rows as float32 (int8 or packed int4 codes and scales beside
        them, restored verbatim by `load`), the forward indexes, the
        full-text statistics, the constructor's persisted arguments, ids,
        texts and metadata. A mesh store saves as any other: placement is
        not persisted."""
        self.flush()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n = len(self._ids)
        arrays: dict[str, np.ndarray] = {"valid": self._valid[:n]}
        if self._dense is not None:
            arrays["dense"] = self._dense_rows_f32(n)
            if self._dense_quantized:
                key = "dense_i4" if self.dense_dtype == "int4" else "dense_i8"
                arrays[key] = self._dense[:n].cpu().numpy()
                arrays["dense_scale"] = self._dense_scale[:n].cpu().numpy()
        if self._sp_ids is not None:
            arrays["sp_ids"] = self._sp_ids[:n].cpu().numpy()
            arrays["sp_w"] = self._sp_w[:n].cpu().numpy()
        if self.enable_full_text and self._ft_ids is not None:
            arrays["ft_ids"] = self._ft_ids[:n].cpu().numpy()
            arrays["ft_tf"] = self._ft_tf[:n].cpu().numpy()
            arrays["doc_len"] = self._doc_len[:n]
            arrays["doc_freq"] = self._doc_freq
        np.savez_compressed(path + ".npz", **arrays)
        with open(path + ".json", "w") as f:
            json.dump(
                {
                    "config": self._config(),
                    "ids": self._ids,
                    "texts": self._texts,
                    "enhanced": self._enhanced,
                    "metadata": self._metadata,
                },
                f,
                default=json_safe,
            )

    @classmethod
    def load(cls, path: str, mesh=None, device=None) -> "DeviceVectorStore":
        """Load a saved index (either package's) onto ``device`` (``None`` →
        ``cuda``), or row-sharded over ``mesh``: every record re-ingested in
        one flush (the forward-index rows with their nonzero terms first, as
        the JAX store's term dicts pad them), the int8 / int4 codes and
        scales restored verbatim, tombstones re-applied without
        auto-compaction."""
        with open(path + ".json") as f:
            meta = json.load(f)
        store = cls(**meta["config"], mesh=mesh, device=device)
        # Each member of the archive is read (and decompressed) once.
        arrays = dict(np.load(path + ".npz", allow_pickle=False))
        records = []
        dense = arrays.get("dense")
        sp_rows = None
        if "sp_ids" in arrays:
            sp_ids, sp_w = arrays["sp_ids"], arrays["sp_w"]
            if sp_ids.shape[1] <= store.sparse_max_nnz:
                sp_rows = _nonzero_first(sp_ids, sp_w)
        for i, rid in enumerate(meta["ids"]):
            rec: dict[str, Any] = {
                "id": rid,
                "text": meta["texts"][i],
                "enhanced_text": meta["enhanced"][i],
                "metadata": meta["metadata"][i],
            }
            if dense is not None:
                rec["dense"] = dense[i]
            if sp_rows is not None:
                rec["sparse_arrays"] = (sp_rows[0][i], sp_rows[1][i])
            elif "sp_ids" in arrays:  # a wider saved index: cut to the heaviest terms
                rec["sparse"] = {int(t): float(w) for t, w in zip(sp_ids[i], sp_w[i]) if w != 0.0}
            records.append(rec)
        store.add_vectors(records)
        store.flush()
        codes_key = {"int8": "dense_i8", "int4": "dense_i4"}.get(store.dense_dtype)
        if codes_key in arrays and store._dense is not None:
            codes = torch.from_numpy(np.asarray(arrays[codes_key], np.int8))
            scales = torch.from_numpy(np.asarray(arrays["dense_scale"], np.float32))
            store._dense[: codes.shape[0]] = codes.to(store.device)
            store._dense_scale[: scales.shape[0]] = scales.to(store.device)
        dead = [meta["ids"][i] for i in np.flatnonzero(~arrays["valid"].astype(bool))]
        if dead:
            # Tombstones only: compaction would re-quantize the rows whose
            # codes were just restored.
            threshold = store.auto_compact_threshold
            store.auto_compact_threshold = None
            try:
                store.delete(dead)
            finally:
                store.auto_compact_threshold = threshold
        return store

    # -- query --------------------------------------------------------------------

    def query(
        self,
        dense_query: np.ndarray | None = None,
        sparse_query: Mapping[int, float] | None = None,
        text_query: str | None = None,
        top_k: int = 10,
        filter: FilterSpec = None,
        search_type: str | None = None,
        hybrid_weights: Mapping[str, float] | None = None,
        rrf_k: int = 60,
        search_params: Mapping[str, Any] | None = None,
    ) -> list[SearchResult]:
        """Single-query search. See `query_batch` for the batched path."""
        results = self.query_batch(
            dense_queries=None if dense_query is None else np.asarray(dense_query)[None, :],
            sparse_queries=None if sparse_query is None else [sparse_query],
            text_queries=None if text_query is None else [text_query],
            top_k=top_k,
            filter=filter,
            search_type=search_type,
            hybrid_weights=hybrid_weights,
            rrf_k=rrf_k,
            search_params=search_params,
        )
        return results[0]

    def query_batch(
        self,
        dense_queries=None,  # [B, d] np.ndarray or torch.Tensor
        sparse_queries=None,  # Sequence[Mapping[int, float]] or (ids, w) arrays
        text_queries: Sequence[str] | None = None,
        top_k: int = 10,
        filter: FilterSpec = None,
        search_type: str | None = None,
        hybrid_weights: Mapping[str, float] | None = None,
        rrf_k: int = 60,
        search_params: Mapping[str, Any] | None = None,
    ) -> list[list[SearchResult]]:
        """Batched search over any combination of methods.

        - filter-only when no query vectors are given;
        - a single method runs alone;
        - several methods (or explicit ``hybrid_weights``) fetch
          ``top_k*2`` per method and fuse with weighted RRF.

        ``text_queries`` serve the BM25 full-text method; a store built
        without ``enable_full_text`` ignores them, as the JAX store does.

        ``search_params``: ``rescore_depth`` (sketch candidates rescored per
        query, bucketed to a power of two in [64, 4096]); ``approx_topk``
        overrides the store's setting for this call (False sends the query
        to the exact "xla" program whatever ``candidate_impl`` is).

        While a profiler records, the call is the span ``store.query_batch``
        with the stages ``store.flush``, ``store.prepare`` (mask, method
        choice, the queries on the device), ``store.program`` (the
        candidate, rescore and RRF program), ``store.readback`` (the wait
        for it and the copy) and ``store.materialize`` (the
        `SearchResult` lists), the same on every route; it counts
        ``store.queries`` and ``store.hits``.
        """
        with profiling.span("store.query_batch"):
            out = self._query_batch(
                dense_queries, sparse_queries, text_queries, top_k, filter,
                search_type, hybrid_weights, rrf_k, search_params,
            )
        if profiling.tracing():
            profiling.count("store.queries", len(out))
            profiling.count("store.hits", sum(map(len, out)))
        return out

    def _query_batch(
        self, dense_queries, sparse_queries, text_queries, top_k, filter,
        search_type, hybrid_weights, rrf_k, search_params,
    ) -> list[list[SearchResult]]:
        with profiling.span("store.flush"):
            self.flush()
        with profiling.span("store.prepare"):
            params = dict(search_params or {})
            depth_override = params.pop("rescore_depth", None)
            approx_override = params.pop("approx_topk", None)
            if params:
                logger.warning("Ignoring unknown search_params keys: %s", sorted(params))
            if depth_override:
                d = max(64, min(int(depth_override), 4096))
                depth_override = 1 << (d - 1).bit_length()
            else:
                depth_override = None
            exact_topk = not (
                self.approx_topk if approx_override is None else bool(approx_override)
            )
            n = len(self._ids)
            if n == 0:
                batch = self._batch_size(dense_queries, sparse_queries, text_queries)
                return [[] for _ in range(max(batch, 1))]

            mask = self._build_mask(filter)

            methods: dict[str, Any] = {}
            if dense_queries is not None and self._dense is not None:
                methods["dense"] = (
                    dense_queries
                    if isinstance(dense_queries, torch.Tensor)
                    else np.asarray(dense_queries, np.float32)
                )
            if sparse_queries is not None and self._sp_ids is not None:
                methods["sparse"] = sparse_queries
            if text_queries is not None and self.enable_full_text:
                methods["full_text"] = text_queries

            if search_type in ("dense", "sparse", "full_text"):
                if search_type not in methods:
                    raise ValueError(
                        f"search_type={search_type!r} requested but that method is "
                        f"unavailable here (available: {sorted(methods) or 'none'})"
                    )
                methods = {search_type: methods[search_type]}

            if not methods:
                asked = [
                    name
                    for name, q in (
                        ("dense", dense_queries),
                        ("sparse", sparse_queries),
                        ("full_text", text_queries),
                    )
                    if q is not None
                ]
                if asked:
                    raise ValueError(
                        f"Query supplied for {asked} but the store has no matching "
                        "index (dense requires dense vectors at ingest; sparse a "
                        "sparse index; full_text enable_full_text=True)"
                    )
                if search_type not in (None, "filter"):
                    raise ValueError(
                        f"Unknown or unavailable search_type {search_type!r} "
                        "(expected 'dense', 'sparse', 'full_text', or None)"
                    )
        if not methods:
            return self._filter_only(mask, top_k, dense_queries, sparse_queries, text_queries)

        if len(methods) == 1 and not hybrid_weights:
            name = next(iter(methods))
            scores, rows = self._run_method(
                name, methods[name], top_k, mask,
                exact_topk=exact_topk, depth_override=depth_override,
            )
            return self._materialize(scores, rows)

        from verbatim_rag_tpu_torch.ops.fusion import normalize_weights, rrf_fuse_np

        weights = dict(hybrid_weights) if hybrid_weights else {m: 1.0 for m in methods}
        weights = normalize_weights({m: [] for m in methods}, weights)
        fetch_k = min(top_k * 2, n)

        if (
            set(methods) in ({"dense", "sparse"}, {"dense", "sparse", "full_text"})
            and self.sparse_mode == "projected"
            and self._dense is not None
            and self._sp_proj is not None
            and ("full_text" not in methods or self._ft_proj is not None)
        ):
            # One call for every arm: 2-way, or 3-way with BM25 full text.
            scores, rows = self._hybrid_projected(
                methods["dense"], methods["sparse"], top_k, fetch_k, mask,
                weights, rrf_k, exact_topk=exact_topk, depth_override=depth_override,
                text_q=methods.get("full_text"),
            )
            return self._materialize(scores, rows)
        all_rows, w_list = [], []
        for name, payload in methods.items():
            scores, rows = self._run_method(
                name, payload, fetch_k, mask,
                exact_topk=exact_topk, depth_override=depth_override,
            )
            all_rows.append(np.where(scores > -1e29, rows, -1))
            w_list.append(weights.get(name, 0.0))

        with profiling.span("store.program"):  # this route's RRF runs on the host
            fused_scores, fused_rows = rrf_fuse_np(
                np.stack(all_rows), np.asarray(w_list, np.float32),
                k=min(top_k, fetch_k), rrf_k=rrf_k,
            )
        return self._materialize(fused_scores, fused_rows)

    # -- internals -------------------------------------------------------------------

    @staticmethod
    def _batch_size(dense, sparse, text) -> int:
        if dense is not None:
            return len(dense)
        if sparse is not None:
            return len(sparse[0]) if _is_sparse_arrays(sparse) else len(sparse)
        if text is not None:
            return len(text)
        return 1

    def _sparse_query_device(self, payload, vocab: int):
        """Sparse query payload → device ``(q_ids, q_w, q_proj)``.

        Array payloads are sketched on the device; dict payloads are
        sketched and padded on the host, then uploaded."""
        from verbatim_rag_tpu_torch.ops.sparse_projected import (
            project_query_arrays,
            project_sparse_queries,
        )

        if _is_sparse_arrays(payload):
            q_ids = torch.as_tensor(payload[0]).to(self.device, torch.int32).contiguous()
            q_w = torch.as_tensor(payload[1]).to(self.device, torch.float32).contiguous()
            q_proj = project_query_arrays(q_ids, q_w, self._projection_dev(vocab))
            return q_ids, q_w, q_proj
        rows = list(payload)
        q_proj = torch.from_numpy(project_sparse_queries(rows, self._projection(vocab)))
        q_ids, q_w = self._pad_sparse_queries(rows)
        return (
            torch.from_numpy(q_ids).to(self.device),
            torch.from_numpy(q_w).to(self.device),
            q_proj.to(self.device),
        )

    def _build_mask(self, filter: FilterSpec) -> torch.Tensor:
        if filter is None and self._valid_dev is not None:
            return self._valid_dev
        n = len(self._ids)
        filter_mask = compile_filter(filter, n, self._promoted, self._metadata)
        host = np.zeros(self._capacity, bool)
        host[:n] = self._valid[:n]
        if filter_mask is not None:
            host[:n] &= filter_mask
        return self._place(torch.from_numpy(host).to(self.device))

    def _dense_queries(self, payload) -> torch.Tensor:
        if isinstance(payload, torch.Tensor):
            return payload.to(self.device)
        return torch.from_numpy(np.asarray(payload, np.float32)).to(self.device)

    def _run_method(
        self, name: str, payload, k: int, mask,
        exact_topk: bool = True, depth_override: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Run one retrieval method → host (scores [B,k], rows [B,k]; -1 pad).

        Dense-only queries score the [B, N] matrix whatever the store's
        ``candidate_impl`` (as in the JAX store, which runs `dense_topk`;
        `sharded_dense_topk` on a mesh). Sparse and full-text queries take
        the projected search, or the exact scan under ``sparse_mode="exact"``."""
        from verbatim_rag_tpu_torch.ops.dense import candidate_topk, normalize_rows

        k = min(k, self._capacity)
        if name == "dense":
            with profiling.span("store.prepare"):
                q = normalize_rows(self._dense_queries(payload))
                dense_c, dense_s = self._dense_scoring_args()
            with profiling.span("store.program"):
                if self.mesh is not None:
                    from verbatim_rag_tpu_torch.parallel.sharded_search import sharded_dense_topk

                    scores, rows = sharded_dense_topk(
                        dense_c, q, k, mask, self.mesh, exact_topk=exact_topk, corpus_scale=dense_s
                    )
                else:
                    scores, rows = candidate_topk(dense_c, q, k, mask, scale=dense_s)
            return self._readback(scores, rows)
        if name == "sparse":
            if self.sparse_mode == "projected":
                return self._projected_search(
                    payload, self._sp_proj, self._sp_ids, self._sp_w, self.sparse_vocab,
                    k, mask, exact_topk=exact_topk, depth_override=depth_override,
                    scale_dev=self._sp_proj_scale,
                )
            with profiling.span("store.prepare"):
                q_dense = self._densify_host(self._sparse_payload_dicts(payload), self.sparse_vocab)
            return self._exact_sparse_topk(self._sp_ids, self._sp_w, q_dense, k, mask)
        if name == "full_text":
            with profiling.span("store.prepare"):
                q_sparse = self._bm25_query_sparse(payload)
            if self.sparse_mode == "projected":
                return self._projected_search(
                    q_sparse, self._ft_proj, self._ft_ids, self._ft_w, self.full_text_vocab,
                    k, mask, exact_topk=exact_topk, depth_override=depth_override,
                    scale_dev=self._ft_proj_scale,
                )
            with profiling.span("store.prepare"):
                q_dense = self._densify_host(q_sparse, self.full_text_vocab)
            return self._exact_sparse_topk(self._ft_ids, self._ft_w, q_dense, k, mask)
        raise ValueError(f"Unknown method {name!r}")

    #: Above this many rows the exact scan is refused unless the store was
    #: built with ``allow_exact_at_scale=True``: it scores every row per query.
    EXACT_SCAN_MAX_ROWS = 200_000

    def _exact_sparse_topk(self, ids_dev, w_dev, q_dense: np.ndarray, k: int, mask):
        """The exact forward-index scan (`ops/sparse.py::sparse_topk`, or
        `sharded_sparse_topk` on a mesh) of densified queries [B, V] → host
        (scores, rows)."""
        from verbatim_rag_tpu_torch.ops.sparse import sparse_topk

        n = len(self._ids)
        if n > self.EXACT_SCAN_MAX_ROWS and not self.allow_exact_at_scale:
            raise RuntimeError(
                f"Exact sparse scan over {n} rows refused: sparse_mode='exact' "
                "(or full-text without projected sketches) scores every "
                "forward-index row per query, far slower than "
                "sparse_mode='projected' at this scale. Use projected mode, "
                "or pass allow_exact_at_scale=True for validation runs."
            )
        with profiling.span("store.prepare"):
            q = torch.from_numpy(q_dense).to(self.device)
        with profiling.span("store.program"):
            if self.mesh is not None:
                from verbatim_rag_tpu_torch.parallel.sharded_search import sharded_sparse_topk

                scores, rows = sharded_sparse_topk(ids_dev, w_dev, q, k, mask, self.mesh, block=self.block)
            else:
                scores, rows = sparse_topk(ids_dev, w_dev, q, k, mask, block=self.block)
        return self._readback(scores, rows)

    @staticmethod
    def _readback(scores: torch.Tensor, rows: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """A program's (scores, rows) on the host: the wait for the device
        and the copy, as the span ``store.readback``."""
        with profiling.span("store.readback"):
            return scores.cpu().numpy(), rows.cpu().numpy()

    @staticmethod
    def _sparse_payload_dicts(payload) -> list[dict[int, float]]:
        """Sparse query payload → list of {term: weight} dicts (an array
        payload is read back once)."""
        if not _is_sparse_arrays(payload):
            return list(payload)
        ids, w = (np.asarray(torch.as_tensor(x).cpu()) for x in payload)
        return [
            {int(t): float(x) for t, x in zip(ids[i], w[i]) if x != 0.0}
            for i in range(len(ids))
        ]

    @staticmethod
    def _densify_host(sparse_rows: Sequence[Mapping[int, float]], vocab: int) -> np.ndarray:
        q = np.zeros((len(sparse_rows), vocab), np.float32)
        for i, row in enumerate(sparse_rows):
            for t, w in row.items():
                t = int(t)
                if 0 <= t < vocab:
                    q[i, t] += float(w)
        return q

    def _bm25_query_sparse(self, texts: Sequence[str]) -> list[dict[int, float]]:
        """BM25 query side: {term: idf(term)} per text, idf over the live
        rows (N counts live rows; df drops a row's terms when it is
        deleted), computed in float64 and rounded to float32."""
        n_rows = len(self._ids)
        n = max(int(self._valid[:n_rows].sum()), 1)
        df = np.maximum(self._doc_freq.astype(np.float64), 0.0)
        idf = np.log1p((n - df + 0.5) / (df + 0.5)).astype(np.float32)
        slots, _, offsets, _ = analyze_texts(list(texts), self.full_text_vocab)
        return [
            {int(t): float(idf[t]) for t in slots[offsets[i] : offsets[i + 1]]}
            for i in range(len(texts))
        ]

    #: Query-nnz padding buckets (the JAX store's compile-shape buckets; kept
    #: so padded query arrays have the same shapes on both sides).
    _QUERY_NNZ_BUCKETS = (16, 32, 64, 128, 256)

    @classmethod
    def _pad_sparse_queries(
        cls, sparse_rows: Sequence[Mapping[int, float]]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pad sparse query dicts to [B, qm] id/weight arrays (bucketed qm)."""
        max_nnz = max(
            (sum(1 for w in row.values() if w != 0.0) for row in sparse_rows),
            default=1,
        )
        max_nnz = max(max_nnz, 1)
        qm = next(
            (b for b in cls._QUERY_NNZ_BUCKETS if b >= max_nnz),
            -(-max_nnz // 256) * 256,
        )
        ids = np.zeros((len(sparse_rows), qm), np.int32)
        weights = np.zeros((len(sparse_rows), qm), np.float32)
        for i, row in enumerate(sparse_rows):
            ids[i], weights[i] = _pad_sparse(row, qm)
        return ids, weights

    def _hybrid_projected(
        self,
        dense_q,
        sparse_q,
        top_k: int,
        fetch_k: int,
        mask,
        weights: Mapping[str, float],
        rrf_k: int,
        exact_topk: bool = True,
        depth_override: int | None = None,
        text_q: Sequence[str] | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """The hybrid serving path in one call, then one [B, k] readback:
        the section tables (`ops/section.py`) when ``candidate_impl="section"``
        can serve the query, else candidate selection per arm
        (`ops/hybrid.py`); exact sparse rescores and weighted RRF either way.
        With ``text_q`` the BM25 arm joins as the third arm of the same call
        (`hybrid_section_topk_3way`, `hybrid_fused_topk_3way`). On a mesh the
        same programs run per shard (`sharded_hybrid_section_topk`,
        `sharded_hybrid_topk`, with the BM25 arm as their ``ft_arm``)."""
        from verbatim_rag_tpu_torch.ops.dense import normalize_rows

        with profiling.span("store.prepare"):
            depth = min(max(depth_override or self.rescore_depth, fetch_k), self._capacity)
            if isinstance(dense_q, torch.Tensor):
                q = normalize_rows(dense_q.to(self.device))
            else:
                q = np.asarray(dense_q, np.float32)
                q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
                q = torch.from_numpy(q).to(self.device)
            q_ids, q_w, q_proj = self._sparse_query_device(sparse_q, self.sparse_vocab)
            dense_c, dense_s = self._dense_scoring_args()
            sketch_c, sketch_s = self._sketch_scoring_args(self._sp_proj, self._sp_proj_scale)
            section = self.candidate_impl == "section" and self._section_serves(exact_topk)
            common = dict(
                k=min(top_k, fetch_k),
                fetch_k=fetch_k,
                depth=depth,
                mask=mask,
                rrf_k=rrf_k,
                dense_scale=dense_s,
                sketch_scale=sketch_s,
                rescore_impl=self.rescore_impl,
            )
            if section:
                shard_rows = self._capacity // (self.mesh.size if self.mesh is not None else 1)
                common["block_cols"] = 16384 if shard_rows % 16384 == 0 else 8192
            else:
                common.update(exact_topk=exact_topk, candidate_impl=self._per_stage_candidate_impl)
            ft = None
            if text_q is not None:
                ft_ids, ft_w, ft_proj = self._sparse_query_device(
                    self._bm25_query_sparse(text_q), self.full_text_vocab
                )
                ft_sketch, ft_scale = self._sketch_scoring_args(self._ft_proj, self._ft_proj_scale)
                ft = (ft_sketch, self._ft_ids, self._ft_w, ft_proj, ft_ids, ft_w, ft_scale)

        with profiling.span("store.program"):
            if self.mesh is not None:
                from verbatim_rag_tpu_torch.parallel.sharded_search import (
                    sharded_hybrid_section_topk,
                    sharded_hybrid_topk,
                )

                program = sharded_hybrid_section_topk if section else sharded_hybrid_topk
                ft_arm = None
                if ft is not None:
                    ft_arm = (*ft[:6], float(weights.get("full_text", 0.5)), ft[6])
                scores, rows = program(
                    dense_c, sketch_c, self._sp_ids, self._sp_w, q, q_proj, q_ids, q_w,
                    mesh=self.mesh,
                    dense_weight=float(weights.get("dense", 0.5)),
                    sparse_weight=float(weights.get("sparse", 0.5)),
                    ft_arm=ft_arm,
                    **common,
                )
            elif ft is not None:
                from verbatim_rag_tpu_torch.ops.hybrid import hybrid_fused_topk_3way
                from verbatim_rag_tpu_torch.ops.section import hybrid_section_topk_3way

                ft_sketch, ft_ids_dev, ft_w_dev, ft_proj, ft_ids, ft_w, ft_scale = ft
                program = hybrid_section_topk_3way if section else hybrid_fused_topk_3way
                scores, rows = program(
                    dense_c, sketch_c, self._sp_ids, self._sp_w,
                    ft_sketch, ft_ids_dev, ft_w_dev,
                    q, q_proj, q_ids, q_w, ft_proj, ft_ids, ft_w,
                    dense_weight=float(weights.get("dense", 1 / 3)),
                    sparse_weight=float(weights.get("sparse", 1 / 3)),
                    ft_weight=float(weights.get("full_text", 1 / 3)),
                    ft_scale=ft_scale,
                    **common,
                )
            else:
                from verbatim_rag_tpu_torch.ops.hybrid import hybrid_fused_topk
                from verbatim_rag_tpu_torch.ops.section import hybrid_section_topk

                program = hybrid_section_topk if section else hybrid_fused_topk
                scores, rows = program(
                    dense_c, sketch_c, self._sp_ids, self._sp_w, q, q_proj, q_ids, q_w,
                    dense_weight=float(weights.get("dense", 0.5)),
                    sparse_weight=float(weights.get("sparse", 0.5)),
                    **common,
                )
        return self._readback(scores, rows)

    def _section_serves(self, exact_topk: bool = False) -> bool:
        """Whether the section tables can serve this query.

        Exactness: a query asking for exact selection (approx_topk=False)
        falls back to the "xla" program, since the tables keep one winner
        per bucket. Geometry: the tables cut each shard's rows into 8192-row
        blocks, so the capacity must be a multiple of (shards · 8192) (the
        default block guarantees it without a mesh; the constructor checks
        it on one). Each fallback logs one warning per reason."""
        reason = None
        shards = self.mesh.size if self.mesh is not None else 1
        if exact_topk:
            reason = (
                "exact selection requested (approx_topk=False) — the "
                "kernel's bucket table is approximate by construction"
            )
        elif self._capacity % (shards * 8192) != 0:
            reason = (
                f"capacity {self._capacity} does not tile the section "
                f"kernel's 8192-row blocks over {shards} shard(s) "
                "(custom block size?)"
            )
        if reason is None:
            return True
        if reason not in self._warned_section_fallback:
            logger.warning(
                "candidate_impl='section' cannot serve this query (%s); "
                "using the per-arm hybrid program instead",
                reason,
            )
            self._warned_section_fallback.add(reason)
        return False

    def _projected_search(
        self, q_sparse, proj_corpus, ids_dev, weights_dev, vocab: int, k: int, mask,
        exact_topk: bool = True, depth_override: int | None = None, scale_dev=None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Two-phase sparse search on the device over one sparse arm (SPLADE
        or BM25): sketch candidates, exact forward-index rescore, final
        top-k (per shard and merged on a mesh)."""
        from verbatim_rag_tpu_torch.ops.hybrid import projected_sparse_topk

        with profiling.span("store.prepare"):
            depth = min(max(depth_override or self.rescore_depth, 2 * k), self._capacity)
            q_ids, q_w, q_proj = self._sparse_query_device(q_sparse, vocab)
            proj_corpus, scale_dev = self._sketch_scoring_args(proj_corpus, scale_dev)
        program = projected_sparse_topk
        if self.mesh is not None:
            from verbatim_rag_tpu_torch.parallel.sharded_search import sharded_projected_sparse_topk

            program = functools.partial(sharded_projected_sparse_topk, mesh=self.mesh)
        with profiling.span("store.program"):
            top_scores, top_rows = program(
                proj_corpus, ids_dev, weights_dev, q_proj, q_ids, q_w,
                min(k, self._capacity), depth, mask,
                exact_topk=exact_topk,
                sketch_scale=scale_dev,
                rescore_impl=self.rescore_impl,
                candidate_impl=self._per_stage_candidate_impl,
            )
        return self._readback(top_scores, top_rows)

    def _filter_only(self, mask, top_k, *query_args) -> list[list[SearchResult]]:
        batch = self._batch_size(*query_args)
        with profiling.span("store.readback"):
            rows = np.flatnonzero(mask[: len(self._ids)].cpu().numpy())[:top_k]
        with profiling.span("store.materialize"):
            hits = [self._result_for(int(r), 0.0) for r in rows]
            return [list(hits) for _ in range(max(batch, 1))]

    def _materialize(self, scores, rows) -> list[list[SearchResult]]:
        with profiling.span("store.materialize"):
            scores = np.asarray(scores)
            rows = np.asarray(rows)
            out: list[list[SearchResult]] = []
            n = len(self._ids)
            for b in range(rows.shape[0]):
                hits = []
                for score, row in zip(scores[b], rows[b]):
                    if row < 0 or row >= n or score <= -1e29:
                        continue
                    hits.append(self._result_for(int(row), float(score)))
                out.append(hits)
            return out

    def _result_for(self, row: int, score: float) -> SearchResult:
        return SearchResult(
            id=self._ids[row],
            score=score,
            text=self._texts[row],
            enhanced_text=self._enhanced[row],
            metadata=self._metadata[row],
        )

    # -- browsing -----------------------------------------------------------------

    def get(self, record_id: str) -> SearchResult | None:
        self.flush()
        row = self._row_of.get(record_id)
        if row is None or not self._valid[row]:
            return None
        return self._result_for(row, 0.0)

    def get_by_filter(self, filter: FilterSpec, limit: int = 100) -> list[SearchResult]:
        self.flush()
        n = len(self._ids)
        mask = compile_filter(filter, n, self._promoted, self._metadata)
        keep = self._valid[:n] if mask is None else (self._valid[:n] & mask)
        rows = np.flatnonzero(keep)[:limit]
        return [self._result_for(int(r), 0.0) for r in rows]
