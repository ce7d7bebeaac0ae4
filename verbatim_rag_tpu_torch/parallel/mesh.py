"""Device meshes and row placement (port of
`verbatim_rag_tpu/parallel/mesh.py`: the mesh, ``row_sharding`` and
``replicated``).

The JAX package is single-controller: one process drives every shard of a
``shard_map``. The port keeps that model. A :class:`Mesh` is a ``[dp, tp]``
grid of ``torch.device``\\ s, a sequence-sharded array is a list of per-device
chunks (`ops.ring_attention.shard_sequence`), a row-sharded array is a
:class:`RowSharded` list of per-device row blocks, and a collective is a copy
between the devices of such a list. A device may appear more than once: a
mesh of repeated ``"cpu"`` devices stands in for JAX's virtual CPU devices,
and ``[cuda:0] * n`` runs n shards on one card, one after another.
"""

from __future__ import annotations

import torch

from verbatim_rag_tpu_torch.device import resolve_device


class Mesh:
    """A ``[dp, tp]`` grid of devices with named axes ``("dp", "tp")``.

    ``shape`` maps each axis name to its size, as JAX's ``Mesh.shape`` does.
    """

    axis_names = ("dp", "tp")

    def __init__(self, grid: list[list[torch.device]]):
        self.devices = [list(row) for row in grid]
        self.shape = {"dp": len(self.devices), "tp": len(self.devices[0]) if self.devices else 0}

    @property
    def size(self) -> int:
        """The number of devices (JAX's ``mesh.size``)."""
        return self.shape["dp"] * self.shape["tp"]

    @property
    def flat_devices(self) -> list[torch.device]:
        """Every device, dp-major: the order of JAX's combined ``("dp", "tp")``
        axis, in which row shards are laid out and gathered."""
        return [d for row in self.devices for d in row]

    def axis_devices(self, axis: str = "tp") -> list[torch.device]:
        """The devices along ``axis`` at index 0 of the other axis: where a
        sequence sharded over ``axis`` lives."""
        if axis == "tp":
            return list(self.devices[0])
        if axis == "dp":
            return [row[0] for row in self.devices]
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {self.axis_names}")


def _device(d) -> torch.device:
    """A concrete device: ``cuda`` gains the current index, so that it equals
    the device of a tensor placed there."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: int | None = None, tp: int = 1, devices: list | None = None) -> Mesh:
    """Build a ('dp', 'tp') mesh. Defaults: every visible CUDA device, all on dp.

    ``devices`` may name a device more than once (``["cpu"] * 8``,
    ``[torch.device("cuda")] * 4``). Raises without a GPU when no devices
    are given.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    return Mesh([devices[i * tp : (i + 1) * tp] for i in range(dp)])


class RowSharded:
    """A ``[N, ...]`` array sharded by rows over a mesh (JAX's
    ``P(("dp", "tp"))``): shard i lives on device ``dp_i * tp + tp_i`` and
    holds rows ``[i*N/n, (i+1)*N/n)``.

    Global-row slices read back as one tensor on the first shard's device,
    and global rows (a slice, or an index list or tensor) are written in
    place into the shards that hold them; that is all the store needs of a
    placed array besides its per-shard programs.
    """

    def __init__(self, shards: list[torch.Tensor]):
        self.shards = list(shards)
        self.rows_per_shard = self.shards[0].shape[0]
        if any(s.shape[0] != self.rows_per_shard for s in self.shards):
            raise ValueError("every shard must hold the same number of rows")

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.rows_per_shard * len(self.shards), *self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.shards)

    def map(self, fn, *others: "RowSharded") -> "RowSharded":
        """``fn`` applied shard by shard (to this array's shard and each of
        ``others``' shard at the same index)."""
        return RowSharded(
            [fn(s, *(o.shards[i] for o in others)) for i, s in enumerate(self.shards)]
        )

    def __getitem__(self, rows: slice) -> torch.Tensor:
        start, stop, step = rows.indices(self.shape[0])
        if step != 1:
            raise ValueError("RowSharded reads contiguous row ranges")
        m, dev = self.rows_per_shard, self.device
        parts = [
            self.shards[i][max(start - i * m, 0) : min(stop - i * m, m)].to(dev)
            for i in range(len(self.shards))
            if i * m < stop and (i + 1) * m > start
        ]
        if not parts:
            return self.shards[0][:0]
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def __setitem__(self, rows, value) -> None:
        m = self.rows_per_shard
        if isinstance(rows, slice):
            start, stop, step = rows.indices(self.shape[0])
            if step != 1:
                raise ValueError("RowSharded writes contiguous row ranges")
            value = torch.as_tensor(value)
            if value.dim() == 0:
                value = value.expand(stop - start, *self.shape[1:])
            for i, shard in enumerate(self.shards):
                lo, hi = max(start, i * m), min(stop, (i + 1) * m)
                if lo < hi:
                    shard[lo - i * m : hi - i * m] = value[lo - start : hi - start].to(
                        shard.device, shard.dtype
                    )
            return
        rows = torch.as_tensor(rows).reshape(-1).long()
        value = torch.as_tensor(value)
        for i, shard in enumerate(self.shards):
            take = (rows >= i * m) & (rows < (i + 1) * m)
            if bool(take.any()):
                local = (rows[take] - i * m).to(shard.device)
                part = value if value.dim() == 0 else value[take.to(value.device)]
                shard[local] = part.to(shard.device, shard.dtype)


def row_sharding(x: torch.Tensor, mesh: Mesh) -> RowSharded:
    """Place a [N, ...] array row-sharded over every device of the mesh
    (N must be a multiple of the mesh size)."""
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not shard evenly over {n} devices")
    m = x.shape[0] // n
    return RowSharded([x[i * m : (i + 1) * m].to(d) for i, d in enumerate(mesh.flat_devices)])


def replicated(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A copy of ``x`` on every device of the mesh, dp-major (a device that
    appears more than once shares one copy)."""
    copies: dict[torch.device, torch.Tensor] = {}
    return [copies.setdefault(d, x.to(d)) for d in mesh.flat_devices]
