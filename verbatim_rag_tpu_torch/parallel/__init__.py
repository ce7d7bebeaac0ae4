"""Parallelism over a mesh of devices: the mesh, row placement and
tensor-parallel parameters (`mesh`), the row-sharded searches of
`sharded_search`, and the process group of `distributed`
(sequence-parallel attention lives in `ops.ring_attention`)."""

from . import distributed
from .distributed import global_mesh, initialize, process_local_batch_slice
from .mesh import (
    Mesh,
    RowSharded,
    ShardedModel,
    data_sharding,
    encoder_param_specs,
    make_mesh,
    replicated,
    row_sharding,
    shard_params,
)
from .sharded_search import replicate, shard_rows, sharded_dense_topk, sharded_sparse_topk

__all__ = [
    "Mesh",
    "RowSharded",
    "ShardedModel",
    "data_sharding",
    "distributed",
    "encoder_param_specs",
    "global_mesh",
    "initialize",
    "make_mesh",
    "process_local_batch_slice",
    "replicate",
    "replicated",
    "row_sharding",
    "shard_params",
    "shard_rows",
    "sharded_dense_topk",
    "sharded_sparse_topk",
]
