"""Multi-process initialization on ``torch.distributed`` (port of
`verbatim_rag_tpu/parallel/distributed.py`).

The JAX package joins processes with ``jax.distributed`` so that one mesh
spans every process's devices. The port keeps its single-controller mesh per
process (`parallel.mesh`) and joins processes with a ``torch.distributed``
process group: each process drives the mesh over its own devices
(:func:`global_mesh`) on its slice of every global batch
(:func:`process_local_batch_slice`), and the trainer sums the data-parallel
gradients, loss denominators and metric counts over the group as well
(:func:`all_reduce_sum`, :func:`all_reduce_grads`, fed each logical
tensor's owner copy on the process's mesh). That is the port's form
of JAX's ``dp`` axis across processes. The row-sharded searches of
`sharded_search` span the group too: each rank holds its block of the
index over its mesh, and each arm's (score, row) pairs are gathered over
the group, as JAX's ``all_gather`` over a mesh of every process's devices.

Every process runs the same program::

    from verbatim_rag_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize()                   # MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    mesh = global_mesh(dp=2, tp=2) # this process's devices

One group serves both devices: each collective goes to the backend of its
tensors' device, gloo for CPU tensors and NCCL for CUDA ones (gloo alone
where PyTorch is built without NCCL), so a process group trains a mesh of
either device.
"""

from __future__ import annotations

import logging
import os

import torch

logger = logging.getLogger(__name__)

#: Port the group listens on when the address names none (torchrun's default).
DEFAULT_PORT = 29500
#: The group's backend by device: a collective on CPU tensors runs on gloo,
#: one on CUDA tensors on NCCL.
BACKEND = "cpu:gloo,cuda:nccl"


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def is_initialized() -> bool:
    dist = _dist()
    return bool(dist and dist.is_initialized())


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the process group; a no-op for a single process.

    With no arguments it reads ``MASTER_ADDR`` (and ``MASTER_PORT``),
    ``WORLD_SIZE`` and ``RANK`` from the environment. Returns True when a
    process group is up: initialized here or already. An explicitly
    configured run (an argument or ``MASTER_ADDR`` given) raises when the
    group cannot be joined, as JAX's ``initialize`` does: silently training
    alone would give each process 1/N of the data.
    """
    address = coordinator_address or os.environ.get("MASTER_ADDR")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not address and num_processes in (None, 1):
        logger.info("Single-process run; torch.distributed not initialized")
        return False
    explicitly_configured = bool(address or num_processes or process_id is not None)
    dist = _dist()
    if dist is None:
        raise RuntimeError("torch.distributed is not available in this build of PyTorch")
    if dist.is_initialized():
        logger.warning("torch.distributed already initialized: process %d/%d", dist.get_rank(), dist.get_world_size())
        return True
    if ":" not in (address or ""):
        address = f"{address or 'localhost'}:{os.environ.get('MASTER_PORT', DEFAULT_PORT)}"
    backend = BACKEND if dist.is_nccl_available() else "gloo"
    try:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{address}",
            world_size=num_processes or 1,
            rank=process_id or 0,
        )
    except (RuntimeError, ValueError) as exc:
        if "already initialized" in str(exc).lower():
            logger.warning("torch.distributed already initialized: %s", exc)
            return True
        if explicitly_configured:
            raise
        logger.warning("torch.distributed initialization failed/skipped: %s", exc)
        return False
    logger.info("torch.distributed initialized (%s): process %d/%d", backend, dist.get_rank(), dist.get_world_size())
    return True


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return _dist().get_rank() if is_initialized() else 0


def global_mesh(dp: int | None = None, tp: int = 1, devices: list | None = None):
    """The ``('dp', 'tp')`` mesh over this process's devices (every visible
    card unless ``devices`` names them, as `parallel.mesh.make_mesh`); the
    process group joins the processes' meshes along ``dp``."""
    from .mesh import make_mesh

    return make_mesh(dp=dp, tp=tp, devices=devices)


def process_local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch this process feeds: its equal share, in
    rank order. Raises ``ValueError`` on a remainder (floor division would
    drop those rows from every step on some process)."""
    n_proc = process_count()
    if global_batch % n_proc != 0:
        raise ValueError(
            f"global_batch ({global_batch}) must divide evenly over "
            f"{n_proc} processes; pad the batch or choose a multiple"
        )
    per_process = global_batch // n_proc
    start = process_index() * per_process
    return slice(start, start + per_process)


def all_reduce_sum(values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Scalars summed over the process group (in one call); unchanged
    without a group of more than one process."""
    if process_count() == 1 or not values:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    _dist().all_reduce(stacked)
    return {k: stacked[i] for i, k in enumerate(keys)}


def all_reduce_grads(params) -> None:
    """Each parameter's gradient summed over the process group, in place.
    On a mesh the trainer passes each logical tensor's owner copy
    (`parallel.mesh.ShardedModel.sync_grads`), before the sum is copied to
    the other copies."""
    if process_count() == 1:
        return
    for p in params:
        if p.grad is not None:
            _dist().all_reduce(p.grad)
