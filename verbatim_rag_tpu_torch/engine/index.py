"""VerbatimIndex — ingest + retrieval orchestration over the device store
(port of `verbatim_rag_tpu/engine/index.py`).

Documents are chunked, embedded in batches by the providers, and appended to
the port's `DeviceVectorStore`; queries resolve their search type (hybrid
iff both providers) and run one batched store query.

With the neural providers (`models.providers`) the SPLADE terms of an ingest
batch reach the store as padded arrays (no per-chunk dicts), and a query
batch's dense embeddings and sparse terms stay on the device from the
encoders into the store's search. ``VERBATIM_DEVICE_HANDOFF=0`` reads the
query encodings back to the host first (the JAX package's A/B switch); both
ways run on the device.

`save` writes the store's files, ``<path>.docs.json`` and the providers'
identities (``<path>.providers.json``) in the JAX package's format; `load`
rebuilds the providers from those identities, so an index saved by either
package loads in the other with the same vector space.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from verbatim_rag_tpu_torch.ingestion.chunkers import ChunkerProvider, MarkdownChunkerProvider
from verbatim_rag_tpu_torch.ingestion.document import Chunk, Document
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.utils import profiling

from .embedding_providers import (
    DenseEmbeddingProvider,
    HashedBowDenseProvider,
    HashedSparseProvider,
    SparseEmbeddingProvider,
    provider_from_config,
)
from .filters import FilterSpec
from .search_result import SearchResult
from .store import DeviceVectorStore, VectorStore, json_safe

logger = logging.getLogger(__name__)


class VerbatimIndex:
    """Hybrid retrieval index: chunk → encode → device arrays → fused search."""

    def __init__(
        self,
        dense_provider: DenseEmbeddingProvider | None = None,
        sparse_provider: SparseEmbeddingProvider | None = None,
        chunker: ChunkerProvider | None = None,
        store: VectorStore | None = None,
        enable_full_text: bool = False,
        db_path: str | None = None,
        mesh=None,
        dense_dtype: str = "bfloat16",
        sketch_dtype: str | None = None,
        device=None,
        **store_kwargs,
    ):
        self.dense_provider = dense_provider
        self.sparse_provider = sparse_provider
        self.chunker = chunker or MarkdownChunkerProvider(split_level=2, min_chunk_size=64)
        self.enable_full_text = enable_full_text
        self.db_path = db_path
        if store is not None:
            if store_kwargs:
                raise TypeError(
                    "store kwargs and an explicit store are mutually exclusive: "
                    f"{sorted(store_kwargs)}"
                )
            self.store = store
        else:
            self.store = DeviceVectorStore(
                dense_dim=dense_provider.get_dimension() if dense_provider else None,
                sparse_vocab=sparse_provider.get_dimension() if sparse_provider else None,
                enable_full_text=enable_full_text,
                mesh=mesh,
                dense_dtype=dense_dtype,
                sketch_dtype=sketch_dtype,
                device=device,
                **store_kwargs,
            )
        #: The device the store's arrays live on; the default extractor of
        #: `VerbatimRAG` follows it.
        self.device = getattr(self.store, "device", None)
        #: document_id → {title, source, metadata, num_chunks}
        self.documents: dict[str, dict[str, Any]] = {}

    # -- ingest --------------------------------------------------------------------

    def add_documents(self, docs: Sequence[DocumentSchema | Document | dict]) -> list[str]:
        """Per-document ingest; returns document ids."""
        ids = []
        for doc in docs:
            document = self._coerce_document(doc)
            self._ingest_chunk_batch(self._prepare_document(document))
            ids.append(document.id)
        self.store.flush()
        return ids

    def add_document(self, doc: DocumentSchema | Document | dict) -> str:
        return self.add_documents([doc])[0]

    def add_documents_bulk(
        self,
        docs: Iterable[DocumentSchema | Document | dict],
        chunk_batch_size: int = 2000,
        doc_batch_size: int = 500,
    ) -> list[str]:
        """Bulk ingest with cross-document chunk batching: chunks accumulate
        across documents and are embedded every ``chunk_batch_size`` chunks /
        ``doc_batch_size`` docs."""
        ids: list[str] = []
        pending: list[dict[str, Any]] = []
        docs_in_batch = 0
        for doc in docs:
            document = self._coerce_document(doc)
            pending.extend(self._prepare_document(document))
            ids.append(document.id)
            docs_in_batch += 1
            if len(pending) >= chunk_batch_size or docs_in_batch >= doc_batch_size:
                self._ingest_chunk_batch(pending)
                pending, docs_in_batch = [], 0
        if pending:
            self._ingest_chunk_batch(pending)
        self.store.flush()
        return ids

    def _coerce_document(self, doc: DocumentSchema | Document | dict) -> Document:
        if isinstance(doc, Document):
            return doc
        if isinstance(doc, DocumentSchema):
            return doc.to_document()
        if isinstance(doc, dict):
            return DocumentSchema(**doc).to_document()
        raise TypeError(f"Cannot ingest {type(doc)!r}")

    def _prepare_document(self, document: Document) -> list[dict[str, Any]]:
        """Chunk a document and assemble un-embedded store records."""
        pairs = self.chunker.chunk(document.content)
        footer = self._document_footer(document)
        records = []
        chunks: list[Chunk] = []
        for i, (raw, enhanced) in enumerate(pairs):
            if not raw.strip():
                continue
            chunk = Chunk(text=raw, enhanced_text=enhanced + footer)
            # System fields last: user metadata must not shadow them.
            metadata = {
                **document.metadata,
                "document_id": document.id,
                "title": document.title or document.metadata.get("title", ""),
                "source": document.source or document.metadata.get("source", ""),
                "chunk_index": i,
            }
            records.append(
                {
                    "id": chunk.id,
                    "text": chunk.text,
                    "enhanced_text": chunk.enhanced_text,
                    "metadata": metadata,
                }
            )
            chunks.append(chunk)
        document.chunks = chunks
        self.documents[document.id] = {
            "title": document.title,
            "source": document.source,
            "metadata": document.metadata,
            "num_chunks": len(records),
        }
        return records

    @staticmethod
    def _document_footer(document: Document) -> str:
        """Title/source/metadata footer appended to enhanced text only."""
        parts = []
        if document.title:
            parts.append(f"Document: {document.title}")
        if document.source:
            parts.append(f"Source: {document.source}")
        for key, value in document.metadata.items():
            if isinstance(value, (str, int, float, bool)):
                parts.append(f"{key}: {value}")
        if not parts:
            return ""
        return "\n\n[" + " | ".join(parts) + "]"

    def _ingest_chunk_batch(self, records: list[dict[str, Any]]) -> None:
        if not records:
            return
        enhanced = [r["enhanced_text"] for r in records]
        if self.dense_provider is not None:
            dense = np.asarray(self.dense_provider.embed_batch(enhanced), np.float32)
            for rec, vec in zip(records, dense):
                rec["dense"] = vec
        if self.sparse_provider is not None:
            if getattr(self.store, "accepts_sparse_arrays", False) and hasattr(
                self.sparse_provider, "embed_batch_arrays"
            ):
                # Padded top-nnz arrays straight into the store's forward
                # index: no per-chunk dict round trip.
                sp_ids, sp_w = self.sparse_provider.embed_batch_arrays(enhanced)
                for rec, row_ids, row_w in zip(records, sp_ids, sp_w):
                    rec["sparse_arrays"] = (row_ids, row_w)
            else:
                for rec, sparse in zip(records, self.sparse_provider.embed_batch(enhanced)):
                    rec["sparse"] = sparse
        self.store.add_vectors(records)

    # -- query ----------------------------------------------------------------------

    def query(
        self,
        text: str | None = None,
        k: int = 5,
        filter: FilterSpec = None,
        search_type: str | None = None,
        hybrid_weights: Mapping[str, float] | None = None,
        rrf_k: int = 60,
        search_params: Mapping[str, Any] | None = None,
    ) -> list[SearchResult]:
        return self.query_batch(
            [text] if text is not None else None,
            k=k,
            filter=filter,
            search_type=search_type,
            hybrid_weights=hybrid_weights,
            rrf_k=rrf_k,
            search_params=search_params,
        )[0]

    def query_batch(
        self,
        texts: Sequence[str] | None,
        k: int = 5,
        filter: FilterSpec = None,
        search_type: str | None = None,
        hybrid_weights: Mapping[str, float] | None = None,
        rrf_k: int = 60,
        search_params: Mapping[str, Any] | None = None,
    ) -> list[list[SearchResult]]:
        """Batched retrieval. Search-type resolution:

        - ``filter`` with no text → filter-only browse;
        - explicit ``hybrid_weights`` → weighted hybrid over the named methods;
        - explicit ``search_type`` in {dense, sparse, hybrid, full_text};
        - otherwise auto: hybrid when both providers exist, else whichever
          single provider is configured.

        While a profiler records, the call is the span ``index.query_batch``
        and the providers' query encodings are ``encode.dense`` and
        ``encode.sparse``.
        """
        with profiling.span("index.query_batch"):
            if texts is None:
                return self.store.query_batch(top_k=k, filter=filter)

            resolved = self._resolve_search_type(search_type, hybrid_weights)
            methods = (
                set(hybrid_weights)
                if hybrid_weights
                else {"dense", "sparse"}
                if resolved == "hybrid"
                else {resolved}
            )
            if hybrid_weights or search_type == "hybrid":
                # An explicit hybrid request must not silently degrade.
                available = {
                    "dense": self.dense_provider is not None,
                    "sparse": self.sparse_provider is not None,
                    "full_text": self.enable_full_text,
                }
                missing = sorted(m for m in methods if not available.get(m, False))
                if missing:
                    raise ValueError(
                        f"Hybrid query requests {missing} but this index has no "
                        "matching provider/full-text config; configure the "
                        "provider or drop the method from the request"
                    )

            # Device handoff (on by default): the neural providers' query
            # encodings stay on the device into the store's search.
            # VERBATIM_DEVICE_HANDOFF=0 materializes them on the host first (the
            # path providers without device outputs always take).
            handoff = os.environ.get("VERBATIM_DEVICE_HANDOFF", "1") != "0" and getattr(
                self.store, "accepts_query_arrays", False
            )
            dense_q = None
            if "dense" in methods and self.dense_provider is not None:
                with profiling.span("encode.dense"):
                    if handoff and hasattr(self.dense_provider, "embed_batch_device"):
                        dense_q = self.dense_provider.embed_batch_device(list(texts))
                    else:
                        dense_q = np.asarray(self.dense_provider.embed_batch(list(texts)), np.float32)
            sparse_q = None
            if "sparse" in methods and self.sparse_provider is not None:
                with profiling.span("encode.sparse"):
                    if handoff and hasattr(self.sparse_provider, "embed_query_arrays_device"):
                        sparse_q = self.sparse_provider.embed_query_arrays_device(list(texts))
                    else:
                        sparse_q = self.sparse_provider.embed_batch(list(texts))
            text_q = list(texts) if "full_text" in methods and self.enable_full_text else None

            return self.store.query_batch(
                dense_queries=dense_q,
                sparse_queries=sparse_q,
                text_queries=text_q,
                top_k=k,
                filter=filter,
                search_type=None if len(methods) > 1 else next(iter(methods)),
                hybrid_weights=hybrid_weights,
                rrf_k=rrf_k,
                search_params=search_params,
            )

    def _resolve_search_type(
        self, search_type: str | None, hybrid_weights: Mapping[str, float] | None
    ) -> str:
        if hybrid_weights:
            return "hybrid"
        if search_type:
            return search_type
        if self.dense_provider is not None and self.sparse_provider is not None:
            return "hybrid"
        if self.dense_provider is not None:
            return "dense"
        if self.sparse_provider is not None:
            return "sparse"
        if self.enable_full_text:
            return "full_text"
        raise ValueError("No embedding providers configured")

    # -- browsing --------------------------------------------------------------------

    def get_document(self, document_id: str) -> dict[str, Any] | None:
        return self.documents.get(document_id)

    def get_all_documents(self) -> list[dict[str, Any]]:
        return [{"id": doc_id, **info} for doc_id, info in self.documents.items()]

    def get_all_chunks(self, limit: int = 100) -> list[SearchResult]:
        return self.store.get_by_filter(None, limit=limit)

    def get_chunks_by_document(self, document_id: str, limit: int = 1000) -> list[SearchResult]:
        return self.store.get_by_filter({"document_id": document_id}, limit=limit)

    def delete_document(self, document_id: str) -> None:
        self.store.delete_document(document_id)
        self.documents.pop(document_id, None)

    def inspect(self) -> dict[str, Any]:
        """Index statistics."""
        return {
            "num_documents": len(self.documents),
            "num_chunks": self.store.count(),
            "dense": self.dense_provider is not None,
            "sparse": self.sparse_provider is not None,
            "full_text": self.enable_full_text,
            "dense_dim": self.dense_provider.get_dimension() if self.dense_provider else None,
            "sparse_vocab": (
                self.sparse_provider.get_dimension() if self.sparse_provider else None
            ),
        }

    # -- persistence -------------------------------------------------------------------

    def save(self, path: str | None = None) -> None:
        """Write ``<path>.npz`` / ``.json`` (the store), ``<path>.docs.json``
        (the documents) and ``<path>.providers.json`` (the providers'
        identities, so `load` rebuilds the same vector space)."""
        path = path or self.db_path
        if not path:
            raise ValueError("No path given and no db_path configured")
        self.store.save(path)
        with open(path + ".docs.json", "w") as f:
            json.dump(self.documents, f, default=json_safe)
        providers = {
            "dense": self.dense_provider.describe() if self.dense_provider else None,
            "sparse": self.sparse_provider.describe() if self.sparse_provider else None,
        }
        with open(path + ".providers.json", "w") as f:
            json.dump(providers, f)

    def load_documents(self, path: str | None = None) -> None:
        path = path or self.db_path
        with open(path + ".docs.json") as f:
            self.documents = json.load(f)

    @classmethod
    def load(
        cls,
        path: str,
        mesh=None,
        dense_provider: DenseEmbeddingProvider | None = None,
        sparse_provider: SparseEmbeddingProvider | None = None,
        device=None,
    ) -> "VerbatimIndex":
        """Load a saved index (either package's) onto ``device`` (``None`` →
        ``cuda``), rebuilding the providers that built it from their
        persisted identities; explicit providers override them. An index
        saved without identities gets the hashed providers, with a warning.
        With a ``mesh`` the store is row-sharded over it at load time, and
        the providers follow the store's device unless ``device`` is given."""
        store = DeviceVectorStore.load(path, mesh=mesh, device=device)
        if device is None:
            device = store.device
        providers_path = path + ".providers.json"
        if os.path.exists(providers_path):
            with open(providers_path) as f:
                identities = json.load(f)
            if dense_provider is None:
                dense_provider = provider_from_config(identities.get("dense"), device=device)
            if sparse_provider is None:
                sparse_provider = provider_from_config(identities.get("sparse"), device=device)
        else:
            if dense_provider is None and store.dense_dim:
                logger.warning(
                    "Index at %s has no provider identity; assuming "
                    "HashedBowDenseProvider(dim=%d). If it was built with a neural "
                    "provider, retrieval will be meaningless: pass the original "
                    "provider explicitly.",
                    path,
                    store.dense_dim,
                )
                dense_provider = HashedBowDenseProvider(dim=store.dense_dim)
            if sparse_provider is None and store.sparse_vocab:
                logger.warning(
                    "Index at %s has no sparse provider identity; assuming "
                    "HashedSparseProvider(vocab_size=%d).",
                    path,
                    store.sparse_vocab,
                )
                sparse_provider = HashedSparseProvider(vocab_size=store.sparse_vocab)
        index = cls(
            dense_provider=dense_provider,
            sparse_provider=sparse_provider,
            store=store,
            enable_full_text=store.enable_full_text,
            db_path=path,
        )
        if os.path.exists(path + ".docs.json"):
            index.load_documents(path)
        return index
