"""Multi-process initialization on ``torch.distributed`` (port of
`verbatim_rag_tpu/parallel/distributed.py`).

The JAX package joins processes with ``jax.distributed`` so that one mesh
spans every process's devices. The port joins processes with a
``torch.distributed`` process group, in two forms:

- :func:`global_mesh` in a group is JAX's global mesh: every rank's devices
  laid out rank-major (as ``jax.devices()`` orders them) and reshaped to
  ``[dp, tp]``, each position tagged with its rank, and the process groups
  of its tp rows and dp columns made on every rank. Any axis may then span
  processes: a sequence sharded over ``tp`` runs ring and halo attention
  across ranks (`ops.ring_attention`, `parallel.exchange`), a tp row runs
  the encoder's root design across ranks (`exchange.TPRow`), and the mesh
  trainer sums gradients, loss counts and the loss over each rank's dp
  column (`mesh.ShardedModel`). A rank passes the global batch and keeps
  its own dp rows (`mesh.data_sharding`).
- A mesh of the process's own devices (`parallel.mesh.make_mesh`) in a group
  is joined along ``dp`` by the whole group: each process feeds its slice
  of every global batch (:func:`process_local_batch_slice`), and the
  trainer sums the gradients, loss denominators and metric counts over the
  group (:func:`all_reduce_sum`, :func:`all_reduce_grads`, fed each logical
  tensor's owner copy on the process's mesh). The row-sharded searches of
  `sharded_search` span the group this way too: each rank holds its block of
  the index over its mesh, and each arm's (score, row) pairs are gathered
  over the group, as JAX's ``all_gather`` over a mesh of every process's
  devices.

Every process runs the same program::

    from verbatim_rag_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize()                   # MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    mesh = global_mesh(dp=2, tp=2) # every process's devices

One group serves both devices: each collective goes to the backend of its
tensors' device, gloo for CPU tensors and NCCL for CUDA ones (gloo alone
where PyTorch is built without NCCL), so a process group trains a mesh of
either device. Where a group runs CUDA tensors on gloo (two ranks that share
one card: NCCL refuses two ranks on a device), the collectives here stage
each tensor through host memory themselves (:func:`stages_on_host`).
"""

from __future__ import annotations

import logging
import os

import torch

from verbatim_rag_tpu_torch.device import resolve_device

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
    """The ``('dp', 'tp')`` mesh over every rank's devices (JAX's
    ``make_mesh`` over ``jax.devices()`` after ``initialize``).

    Each rank contributes its local devices: every visible card, or
    ``devices`` (``["cpu"] * 2``); one ``all_gather`` collects the ranks'
    counts and layouts. Positions are laid out rank-major and reshaped to
    ``[dp, tp]``; every rank then makes the process groups of the tp rows
    and dp columns that span ranks, in one order (the whole mesh's is the
    whole group). Every rank must pass the
    same ``dp`` and ``tp`` and as many devices, each rank's positions must
    be whole tp rows or lie in one tp row, and ``dp·tp`` must be the sum of
    the ranks' devices: otherwise every rank raises ``ValueError`` (after
    the one ``all_gather``, so that none is left waiting in a later
    collective). Without a group it is `parallel.mesh.make_mesh`."""
    from .mesh import Mesh, _device, make_mesh

    if process_count() == 1:
        return make_mesh(dp=dp, tp=tp, devices=devices)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [_device(d) for d in devices]
    world, rank = process_count(), process_index()
    mine = torch.tensor([len(local), -1 if dp is None else dp, tp], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(world)]
    _dist().all_gather(every, mine)
    held = [tuple(t.tolist()) for t in every]
    counts = [h[0] for h in held]
    total = sum(counts)
    layout = f"dp={dp}, tp={tp} over {total} devices ({counts} by rank)"
    if len({h[1:] for h in held}) != 1:
        raise ValueError(f"ranks ask for different meshes, (dp, tp) by rank: {[h[1:] for h in held]}")
    if len(set(counts)) != 1:
        raise ValueError(f"{layout}: every rank must pass as many devices")
    dp = total // tp if dp is None else dp
    if dp * tp != total:
        raise ValueError(f"{layout}: dp·tp must be the sum of the ranks' devices")
    if counts[0] % tp and tp % counts[0]:
        raise ValueError(f"{layout}: a rank's positions must be whole tp rows or lie in one tp row")
    owner = [r for r, n in enumerate(counts) for _ in range(n)]
    ranks = [owner[d * tp : (d + 1) * tp] for d in range(dp)]
    mine_at = iter(local)
    grid = [[next(mine_at) if r == rank else None for r in row] for row in ranks]
    lines = ranks + [[row[t] for row in ranks] for t in range(tp)] + [owner]
    groups = {}
    for line in lines:
        key = tuple(sorted(set(line)))
        if len(key) > 1 and key not in groups:
            groups[key] = _dist().group.WORLD if len(key) == world else _dist().new_group(list(key))
    return Mesh(grid, ranks=ranks, rank=rank, groups=groups)


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


def world():
    """The whole process group, None without a group of more than one
    process (a reduction over None is a no-op here)."""
    return _dist().group.WORLD if process_count() > 1 else None


def stages_on_host(group=None) -> bool:
    """Whether the group runs collectives on CUDA tensors on gloo, which
    the port then stages through host memory (two ranks on one card)."""
    return "nccl" not in str(_dist().get_backend(group))


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as handed to a collective: contiguous, on the host where the
    group stages CUDA tensors there."""
    x = x.detach().contiguous()
    return x.cpu() if x.is_cuda and stages_on_host(group) else x


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` in place (through the host where the
    group stages CUDA tensors); returns ``x``."""
    wire = _wire(x, group)
    _dist().all_reduce(wire, group=group)
    if wire.data_ptr() != x.data_ptr():
        x.copy_(wire)
    return x


def all_reduce_sum(values: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Scalars summed over ``group`` in one call (None, as :func:`world`
    without a group of more than one process: unchanged)."""
    if group is None or not values:
        return values
    keys = list(values)
    stacked = all_reduce_(torch.stack([values[k].detach().float().reshape(()) for k in keys]), group)
    return {k: stacked[i] for i, k in enumerate(keys)}


def all_reduce_tensors(tensors: list[torch.Tensor], group) -> None:
    """Float32 tensors summed over ``group`` in place, as one flat buffer on
    the first tensor's device (one collective)."""
    home = tensors[0].device
    flat = all_reduce_(torch.cat([x.reshape(-1).to(home) for x in tensors]), group)
    for x, part in zip(tensors, flat.split([x.numel() for x in tensors])):
        x.copy_(part.view_as(x))


def all_reduce_grads(params) -> None:
    """Each parameter's gradient summed over the process group, in place.
    On a mesh of this process the trainer passes each logical tensor's owner
    copy (`parallel.mesh.ShardedModel.sync_grads`), before the sum is copied
    to the other copies."""
    if process_count() == 1:
        return
    for p in params:
        if p.grad is not None:
            _dist().all_reduce(p.grad)


def send(x: torch.Tensor, dst: int) -> None:
    """``x`` to rank ``dst`` over the whole group (through the host where
    the group stages CUDA tensors)."""
    _dist().send(_wire(x, None), dst)


def recv(numel: int, src: int, device) -> torch.Tensor:
    """A float32 vector of ``numel`` from rank ``src`` (:func:`send`), on ``device``."""
    device = torch.device(device)
    on_host = device.type == "cuda" and stages_on_host(None)
    buf = torch.empty(numel, dtype=torch.float32, device="cpu" if on_host else device)
    _dist().recv(buf, src)
    return buf.to(device)
