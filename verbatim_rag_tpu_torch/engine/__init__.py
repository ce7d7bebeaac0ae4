"""Device-resident retrieval engine: store, index facade, providers."""

from .embedding_providers import (
    DenseEmbeddingProvider,
    HashedBowDenseProvider,
    HashedSparseProvider,
    SparseEmbeddingProvider,
)
from .filters import FilterSpec, compile_filter
from .index import VerbatimIndex
from .search_result import SearchResult
from .store import DeviceVectorStore, VectorStore

__all__ = [
    "DenseEmbeddingProvider",
    "DeviceVectorStore",
    "FilterSpec",
    "HashedBowDenseProvider",
    "HashedSparseProvider",
    "SearchResult",
    "SparseEmbeddingProvider",
    "VectorStore",
    "VerbatimIndex",
    "compile_filter",
]
