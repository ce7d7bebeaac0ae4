"""Device ops: retrieval scoring, fusion, sequence-parallel attention, and the
hand-written CUDA kernels (flash attention and its ring-step partial, exact
sparse rescore, section and bucket tables) with their plain PyTorch twins.

As in the JAX package, the name ``ring_attention`` here is the function; the
module is ``sys.modules["verbatim_rag_tpu_torch.ops.ring_attention"]``.
``flash_attention`` stays the module (its launch counters are read there);
the function is ``ops.flash_attention.flash_attention``.
"""

from .dense import dense_topk, normalize_rows
from .flash_attention import attention_reference, flash_attention_partial
from .fusion import rrf_fuse_device, rrf_fuse_np, rrf_merge_host
from .hybrid import hybrid_candidates, hybrid_topk
from .ring_attention import halo_attention, ring_attention, shard_sequence
from .sparse import bm25_idf, bm25_saturate, densify_queries, sparse_topk
from .sparse_projected import (
    exact_rescore,
    project_rows,
    project_sparse_queries,
    projection_matrix,
)

__all__ = [
    "attention_reference",
    "bm25_idf",
    "bm25_saturate",
    "dense_topk",
    "densify_queries",
    "exact_rescore",
    "flash_attention_partial",
    "halo_attention",
    "hybrid_candidates",
    "hybrid_topk",
    "normalize_rows",
    "project_rows",
    "project_sparse_queries",
    "projection_matrix",
    "ring_attention",
    "rrf_fuse_device",
    "rrf_fuse_np",
    "rrf_merge_host",
    "shard_sequence",
    "sparse_topk",
]
