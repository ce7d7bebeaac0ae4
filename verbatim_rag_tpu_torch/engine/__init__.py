"""Device-resident retrieval engine: store, index facade, providers.

The neural providers (``JaxDenseProvider``, ``JaxSpladeProvider``) live in
`verbatim_rag_tpu_torch.models.providers` and are exported here on first
access (they import this package's provider contracts).
"""

from .embedding_providers import (
    DenseEmbeddingProvider,
    HashedBowDenseProvider,
    HashedSparseProvider,
    OpenAIEmbeddingProvider,
    SparseEmbeddingProvider,
)
from .filters import FilterSpec, compile_filter
from .index import VerbatimIndex
from .search_result import SearchResult
from .store import DeviceVectorStore, VectorStore

_NEURAL = ("JaxDenseProvider", "JaxSpladeProvider")


def __getattr__(name: str):
    if name in _NEURAL:
        from verbatim_rag_tpu_torch.models import providers

        return getattr(providers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DenseEmbeddingProvider",
    "DeviceVectorStore",
    "FilterSpec",
    "HashedBowDenseProvider",
    "HashedSparseProvider",
    "JaxDenseProvider",
    "JaxSpladeProvider",
    "OpenAIEmbeddingProvider",
    "SearchResult",
    "SparseEmbeddingProvider",
    "VectorStore",
    "VerbatimIndex",
    "compile_filter",
]
