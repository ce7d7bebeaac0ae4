"""Device meshes (port of `verbatim_rag_tpu/parallel/mesh.py`, the mesh part).

The JAX package is single-controller: one process drives every shard of a
``shard_map``. The port keeps that model. A :class:`Mesh` is a ``[dp, tp]``
grid of ``torch.device``\\ s, a sequence-sharded array is a list of per-device
chunks (`ops.ring_attention.shard_sequence`), and a collective is a copy
between the devices of that list. A device may appear more than once: a
mesh of repeated ``"cpu"`` devices stands in for JAX's virtual CPU devices,
and ``[cuda:0] * n`` runs an n-shard ring on one card.
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
