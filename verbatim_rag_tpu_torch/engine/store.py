"""Device-resident hybrid vector store (port of
`verbatim_rag_tpu/engine/store.py`: the bf16/f32 projected-sparse tier and
the int8 tier).

Layout on the store's device (a CUDA device unless ``device="cpu"``):

- dense:    ``[cap, d]`` row-normalized bf16 (or f32), or int8 codes with
            a ``[cap, 1]`` float32 scale column (``dense_dtype="int8"``);
- sparse:   forward index ``ids [cap, m]`` int32 (or int16,
            ``sparse_ids_dtype``) + ``weights [cap, m]`` f32 (or f16,
            ``sparse_weight_dtype``), and its projected sketches ``[cap, d_p]`` in the dense family's
            float dtype, or int8 codes with a ``[cap, 1]`` scale column
            (``sketch_dtype="int8"``);
- validity: ``[cap] bool`` — deletes flip it (tombstones).

Text and metadata stay on the host. Writes queue in a host buffer; `flush()`
writes them into the device arrays, whose capacity grows geometrically from
``block``. Unlike the JAX store (immutable arrays, a fresh buffer per
write), rows are written in place into the preallocated arrays.

Queries: dense-only, projected-sparse-only, and the 2-way hybrid, which runs
as one call per batch: candidate selection, exact rescore (the CUDA kernel
on the default ``rescore_impl="pallas"``) and weighted RRF, then one [B, k]
readback. Candidate selection follows ``candidate_impl``: "xla" scores the
[B, N] matrices and selects exactly (`ops/hybrid.py::hybrid_fused_topk`);
"section" (what "auto" picks on the int8 tier) builds both arms' packed
bucket tables in one kernel launch (`ops/section.py::hybrid_section_topk`);
"bucket" runs the fused bucket-max kernel per arm (`ops/fused_topk.py`).

Options of the JAX store that later slices serve raise
``NotImplementedError`` naming the slice.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from verbatim_rag_tpu_torch.device import resolve_device

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


def _is_sparse_arrays(payload) -> bool:
    """True when a sparse query payload is an ``(ids, weights)`` array pair
    rather than a sequence of term→weight mappings."""
    return (
        isinstance(payload, tuple)
        and len(payload) == 2
        and not isinstance(payload[0], Mapping)
        and getattr(payload[0], "ndim", None) == 2
    )


def _not_in_slice(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch store yet ({slice_name})"
    )


_STORE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


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
        dense_dtype: str = "bfloat16",
        sketch_dtype: str | None = None,
        block: int = _BLOCK,
        sparse_mode: str = "projected",
        projection_dim: int = 768,
        rescore_depth: int = 256,
        projection_seed: int = 0,
        mesh=None,
        approx_topk: bool = True,
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
        if dense_dtype not in ("bfloat16", "float32", "int8", "int4"):
            raise ValueError(f"unsupported dense_dtype {dense_dtype!r}")
        if sketch_dtype not in (None, "bfloat16", "float32", "int8", "int4"):
            raise ValueError(f"unsupported sketch_dtype {sketch_dtype!r}")
        if sparse_weight_dtype not in ("float32", "float16"):
            raise ValueError(f"unsupported sparse_weight_dtype {sparse_weight_dtype!r}")
        if sparse_ids_dtype not in ("int32", "int16"):
            raise ValueError(f"unsupported sparse_ids_dtype {sparse_ids_dtype!r}")
        if sparse_ids_dtype == "int16" and sparse_vocab is not None and sparse_vocab > 32768:
            raise ValueError(
                f"sparse_ids_dtype='int16' holds vocab ids < 32768; "
                f"sparse_vocab is {sparse_vocab}"
            )
        if dense_dtype == "int4" or sketch_dtype == "int4":
            raise _not_in_slice("int4 dense and sketch rows", "the int4 capacity slice")
        if mesh is not None:
            raise _not_in_slice("a mesh", "the parallel slice")
        if enable_full_text:
            raise _not_in_slice("enable_full_text (BM25)", "the persistence and BM25 slice")
        if sparse_mode == "exact":
            raise _not_in_slice("sparse_mode='exact'", "the persistence and BM25 slice")
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
            # a store built for exact selection takes the "xla" program.
            candidate_impl = (
                "section"
                if dense_dtype == "int8" and sketch_dtype == "int8" and approx_topk
                else "xla"
            )
        if candidate_impl != "section":
            validate_candidate_impl(candidate_impl)
        self.device = resolve_device(device)
        self.dense_dim = dense_dim
        self.sparse_vocab = sparse_vocab
        self.sparse_max_nnz = sparse_max_nnz
        self.dense_dtype = dense_dtype
        self.sketch_dtype = sketch_dtype
        self.block = block
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
        self._valid_dev = None  # [cap] bool
        self._capacity = 0

    # -- basic accessors -----------------------------------------------------

    @property
    def _dense_store_dtype(self) -> torch.dtype:
        """Device dtype of the dense matrix. ``int8`` is the capacity mode:
        per-row symmetric codes (`ops/dense.py::quantize_rows_int8`) with a
        float32 scale column, half the bytes of bf16."""
        return _STORE_DTYPES[self.dense_dtype]

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
        """Write pending records into the device arrays."""
        if not self._pending:
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

        # Capacity grows as in the JAX store, which sizes for the new rows
        # padded to a fixed row chunk.
        pad_unit = min(_FLUSH_PAD, self.block)
        pad_rows = -(-n_new // pad_unit) * pad_unit
        new_cap = self._target_capacity(offset + pad_rows, first_flush=offset == 0)

        def _write(arr, new_rows, width, dtype):
            arr = self._grow_capacity(arr, new_cap, width, dtype)
            arr[offset : offset + n_new] = torch.as_tensor(new_rows).to(self.device, dtype)
            return arr

        if dense_new is not None:
            if self.dense_dtype == "int8":
                from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int8

                codes, scale = quantize_rows_int8(torch.from_numpy(dense_new).to(self.device))
                self._dense = _write(self._dense, codes, self.dense_dim, torch.int8)
                self._dense_scale = _write(self._dense_scale, scale, 1, torch.float32)
            else:
                self._dense = _write(
                    self._dense, dense_new, self.dense_dim, self._dense_store_dtype
                )
        if sp_ids_new is not None:
            from verbatim_rag_tpu_torch.ops.sparse_projected import project_rows

            ids_dev = torch.from_numpy(sp_ids_new).to(self.device)
            w_dev = torch.from_numpy(sp_w_new).to(self.device)
            self._sp_ids = _write(self._sp_ids, ids_dev, self.sparse_max_nnz, self._sp_ids_dtype)
            self._sp_w = _write(self._sp_w, w_dev, self.sparse_max_nnz, self._sp_w_dtype)
            # Sketch the new rows on the device from their float32 weights
            # (the JAX store sketches before any float16 rounding).
            proj_new = project_rows(ids_dev, w_dev, self._projection_dev(self.sparse_vocab))
            if self.sketch_dtype == "int8":
                from verbatim_rag_tpu_torch.ops.dense import quantize_rows_int8

                codes, scale = quantize_rows_int8(proj_new)
                self._sp_proj = _write(self._sp_proj, codes, self.projection_dim, torch.int8)
                self._sp_proj_scale = _write(self._sp_proj_scale, scale, 1, torch.float32)
            else:
                self._sp_proj = _write(
                    self._sp_proj, proj_new, self.projection_dim, self._sketch_store_dtype
                )

        valid = torch.zeros(new_cap, dtype=torch.bool)
        valid[: self._valid.size] = torch.from_numpy(self._valid)
        self._valid_dev = valid.to(self.device)
        self._capacity = new_cap

    def _target_capacity(self, needed: int, first_flush: bool = False) -> int:
        """Next capacity: doubles from `block`. The first flush of an empty
        store sizes tightly (next block multiple)."""
        if first_flush:
            return max(-(-needed // self.block) * self.block, self.block, self._capacity)
        cap = max(self._capacity, self.block)
        while cap < needed:
            cap *= 2
        return cap

    def _grow_capacity(self, old, cap: int, width: int, dtype):
        """Allocate [cap, width] zeros and copy the old rows into the prefix."""
        if old is not None and old.shape[0] >= cap:
            return old
        fresh = torch.zeros((cap, width), dtype=dtype, device=self.device)
        if old is not None:
            fresh[: old.shape[0]] = old
        return fresh

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

    # -- deletes -----------------------------------------------------------------

    def delete(self, ids: list[str]) -> None:
        """Tombstone rows: flip the validity mask (host and device)."""
        self.flush()
        rows = [self._row_of[i] for i in ids if i in self._row_of]
        if not rows:
            return
        self._valid[rows] = False
        if self._valid_dev is not None:
            self._valid_dev[torch.as_tensor(rows, device=self.device)] = False

    def delete_document(self, document_id: str) -> None:
        self.flush()
        rows = [
            i
            for i, m in enumerate(self._metadata)
            if m.get("document_id") == document_id and self._valid[i]
        ]
        self.delete([self._ids[r] for r in rows])

    def compact(self, min_dead_fraction: float = 0.0) -> int:
        raise _not_in_slice("compact()", "the persistence and BM25 slice")

    def save(self, path: str) -> None:
        raise _not_in_slice("save()", "the persistence and BM25 slice")

    @classmethod
    def load(cls, path: str, **kwargs) -> "DeviceVectorStore":
        raise _not_in_slice("load()", "the persistence and BM25 slice")

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
        - dense + sparse (or explicit ``hybrid_weights``) fetch ``top_k*2``
          per method and fuse with weighted RRF.

        ``search_params``: ``rescore_depth`` (sketch candidates rescored per
        query, bucketed to a power of two in [64, 4096]); ``approx_topk``
        overrides the store's setting for this call (False sends the query
        to the exact "xla" program whatever ``candidate_impl`` is).
        """
        self.flush()
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
        if text_queries is not None:
            raise _not_in_slice("full-text queries", "the persistence and BM25 slice")

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
                for name, q in (("dense", dense_queries), ("sparse", sparse_queries))
                if q is not None
            ]
            if asked:
                raise ValueError(
                    f"Query supplied for {asked} but the store has no matching "
                    "index (dense requires dense vectors at ingest; sparse a "
                    "sparse index)"
                )
            if search_type not in (None, "filter"):
                raise ValueError(
                    f"Unknown or unavailable search_type {search_type!r} "
                    "(expected 'dense', 'sparse', 'full_text', or None)"
                )
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

        if set(methods) == {"dense", "sparse"}:
            scores, rows = self._hybrid_projected(
                methods["dense"], methods["sparse"], top_k, fetch_k, mask,
                weights, rrf_k, exact_topk=exact_topk, depth_override=depth_override,
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
        return torch.from_numpy(host).to(self.device)

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
        ``candidate_impl`` (as in the JAX store, which runs `dense_topk`)."""
        from verbatim_rag_tpu_torch.ops.dense import candidate_topk, normalize_rows

        k = min(k, self._capacity)
        if name == "dense":
            q = normalize_rows(self._dense_queries(payload))
            scores, rows = candidate_topk(self._dense, q, k, mask, scale=self._dense_scale)
            return scores.cpu().numpy(), rows.cpu().numpy()
        if name == "sparse":
            return self._projected_search(
                payload, k, mask, exact_topk=exact_topk, depth_override=depth_override
            )
        raise ValueError(f"Unknown method {name!r}")

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
    ) -> tuple[np.ndarray, np.ndarray]:
        """The hybrid serving path in one call, then one [B, k] readback:
        the section tables (`ops/section.py::hybrid_section_topk`) when
        ``candidate_impl="section"`` can serve the query, else candidate
        selection per arm (`ops/hybrid.py::hybrid_fused_topk`); exact
        sparse rescore and weighted RRF either way."""
        from verbatim_rag_tpu_torch.ops.dense import normalize_rows

        depth = min(max(depth_override or self.rescore_depth, fetch_k), self._capacity)
        if isinstance(dense_q, torch.Tensor):
            q = normalize_rows(dense_q.to(self.device))
        else:
            q = np.asarray(dense_q, np.float32)
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
            q = torch.from_numpy(q).to(self.device)
        q_ids, q_w, q_proj = self._sparse_query_device(sparse_q, self.sparse_vocab)
        common = dict(
            k=min(top_k, fetch_k),
            fetch_k=fetch_k,
            depth=depth,
            mask=mask,
            dense_weight=float(weights.get("dense", 0.5)),
            sparse_weight=float(weights.get("sparse", 0.5)),
            rrf_k=rrf_k,
            dense_scale=self._dense_scale,
            sketch_scale=self._sp_proj_scale,
            rescore_impl=self.rescore_impl,
        )
        arrays = (self._dense, self._sp_proj, self._sp_ids, self._sp_w, q, q_proj, q_ids, q_w)
        if self.candidate_impl == "section" and self._section_serves(exact_topk):
            from verbatim_rag_tpu_torch.ops.section import hybrid_section_topk

            scores, rows = hybrid_section_topk(
                *arrays, **common,
                block_cols=16384 if self._capacity % 16384 == 0 else 8192,
            )
        else:
            from verbatim_rag_tpu_torch.ops.hybrid import hybrid_fused_topk

            scores, rows = hybrid_fused_topk(
                *arrays, **common, exact_topk=exact_topk,
                candidate_impl=self._per_stage_candidate_impl,
            )
        return scores.cpu().numpy(), rows.cpu().numpy()

    def _section_serves(self, exact_topk: bool = False) -> bool:
        """Whether the section tables can serve this query.

        Exactness: a query asking for exact selection (approx_topk=False)
        falls back to the "xla" program, since the tables keep one winner
        per bucket. Geometry: the tables cut the rows into 8192-row blocks,
        so the capacity must be a multiple of 8192 (the default block
        guarantees it). Each fallback logs one warning per reason."""
        reason = None
        if exact_topk:
            reason = (
                "exact selection requested (approx_topk=False) — the "
                "kernel's bucket table is approximate by construction"
            )
        elif self._capacity % 8192 != 0:
            reason = (
                f"capacity {self._capacity} does not tile the section "
                "kernel's 8192-row blocks (custom block size?)"
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
        self, q_sparse, k: int, mask, exact_topk: bool = True,
        depth_override: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Two-phase sparse search on the device: sketch candidates, exact
        forward-index rescore, final top-k."""
        from verbatim_rag_tpu_torch.ops.hybrid import projected_sparse_topk

        depth = min(max(depth_override or self.rescore_depth, 2 * k), self._capacity)
        q_ids, q_w, q_proj = self._sparse_query_device(q_sparse, self.sparse_vocab)
        top_scores, top_rows = projected_sparse_topk(
            self._sp_proj, self._sp_ids, self._sp_w, q_proj, q_ids, q_w,
            min(k, self._capacity), depth, mask,
            exact_topk=exact_topk,
            sketch_scale=self._sp_proj_scale,
            rescore_impl=self.rescore_impl,
            candidate_impl=self._per_stage_candidate_impl,
        )
        return top_scores.cpu().numpy(), top_rows.cpu().numpy()

    def _filter_only(self, mask, top_k, *query_args) -> list[list[SearchResult]]:
        batch = self._batch_size(*query_args)
        rows = np.flatnonzero(mask.cpu().numpy()[: len(self._ids)])[:top_k]
        hits = [self._result_for(int(r), 0.0) for r in rows]
        return [list(hits) for _ in range(max(batch, 1))]

    def _materialize(self, scores, rows) -> list[list[SearchResult]]:
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
