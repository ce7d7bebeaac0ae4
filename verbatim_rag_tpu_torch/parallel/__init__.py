"""Parallelism over a mesh of devices: the mesh and row placement, and the
row-sharded searches of `sharded_search` (sequence-parallel attention lives
in `ops.ring_attention`)."""

from .mesh import Mesh, RowSharded, make_mesh, replicated, row_sharding
from .sharded_search import replicate, shard_rows, sharded_dense_topk, sharded_sparse_topk

__all__ = [
    "Mesh",
    "RowSharded",
    "make_mesh",
    "replicate",
    "replicated",
    "row_sharding",
    "shard_rows",
    "sharded_dense_topk",
    "sharded_sparse_topk",
]
