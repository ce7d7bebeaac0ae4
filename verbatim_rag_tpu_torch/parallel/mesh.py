"""Device meshes, row placement and tensor-parallel parameters (port of
`verbatim_rag_tpu/parallel/mesh.py`: the mesh, ``data_sharding``,
``row_sharding``, ``replicated``, ``encoder_param_specs`` and
``shard_params``).

The JAX package is single-controller: one process drives every shard of a
``shard_map``. The port keeps that model. A :class:`Mesh` is a ``[dp, tp]``
grid of ``torch.device``\\ s, a sequence-sharded array is a list of per-device
chunks (`ops.ring_attention.shard_sequence`), a row-sharded array is a
:class:`RowSharded` list of per-device row blocks, and a collective is a copy
between the devices of such a list. A device may appear more than once: a
mesh of repeated ``"cpu"`` devices stands in for JAX's virtual CPU devices,
and ``[cuda:0] * n`` runs n shards on one card, one after another.

Tensor parallelism follows the JAX package's rules (:func:`encoder_param_specs`):
attention q/k/v and MLP wi are cut by output columns over ``tp``, o and wo by
input rows, everything else is replicated. XLA runs such a placement as the
unsharded function; the port runs each shard's part of a layer on its own
device (`models.encoder.encoder_forward_tp`), so the cut must give each shard
a self-contained part: heads for attention, and for a GEGLU MLP the same
block of the gate half and of the value half of wi (JAX splits the global
gate from the global value), with the matching row block of wo.
:func:`shard_params` returns a :class:`ShardedModel` whose logical
parameters stay the model's own: each shard reads its slices of them
(views on the parameters' own device, kept copies on another:
`models.encoder.ReplicaBuffers`), and gradients flow back into the model's parameters,
summed over ``dp``.
"""

from __future__ import annotations

from typing import Iterator, Mapping

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


def data_sharding(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A ``[B, ...]`` batch split by rows over ``dp`` (JAX's ``P("dp")``):
    shard d holds rows ``[d·B/dp, (d+1)·B/dp)`` on ``mesh.devices[d][0]``.
    Raises ``ValueError`` when B does not divide, as JAX's placement does."""
    dp = mesh.shape["dp"]
    if x.shape[0] % dp:
        raise ValueError(f"batch of {x.shape[0]} rows does not divide evenly over dp={dp}")
    n = x.shape[0] // dp
    return [x[d * n : (d + 1) * n].to(mesh.devices[d][0]) for d in range(dp)]


def encoder_param_specs(params) -> dict[str, tuple]:
    """The tensor-parallel spec of each parameter (a model or a
    ``state_dict``): name → one entry per dim, ``"tp"`` on the sharded dim,
    ``()`` for a replicated parameter — JAX's ``PartitionSpec`` tree without
    its stacked layer axis.

    Rules (JAX's, by path):
    - attention q/k/v kernels: output dim (heads) over tp → ``(None, "tp")``
    - attention o kernel: input dim over tp → ``("tp", None)``
    - mlp wi kernel: output (intermediate) dim over tp, and its bias
    - mlp wo kernel: input (intermediate) dim over tp
    - embeddings, norms and every other bias: replicated
    """
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())

    def spec_for(name: str, ndim: int) -> tuple:
        parts = [part for part in name.split(".") if not part.isdigit()]
        joined = "/".join(parts)
        if "attn" in joined and joined.endswith("kernel"):
            if "/o/" in joined or joined.endswith("o/kernel"):
                return (*[None] * (ndim - 2), "tp", None)
            return (*[None] * (ndim - 2), None, "tp")
        if "mlp" in joined and joined.endswith("kernel"):
            if "wi" in parts:
                return (*[None] * (ndim - 2), None, "tp")
            return (*[None] * (ndim - 2), "tp", None)
        if "mlp" in joined and joined.endswith("bias") and "wi" in parts:
            return (*[None] * (ndim - 1), "tp")
        return ()

    return {name: spec_for(name, value.dim()) for name, value in params.items()}


def wi_columns(config, tp: int, t: int) -> list[slice]:
    """Shard t's columns of wi's output: its block of the intermediate dim,
    and for GEGLU that block of the gate half and of the value half."""
    inter = config.intermediate_size
    block = inter // tp
    halves = 2 if config.activation == "geglu" else 1
    return [slice(h * inter + t * block, h * inter + (t + 1) * block) for h in range(halves)]


def tp_slice(name: str, value: torch.Tensor, spec: tuple, config, tp: int, t: int) -> torch.Tensor:
    """Shard t's part of a parameter with a ``"tp"`` spec: a contiguous block
    of the sharded dim, or wi's :func:`wi_columns` (a view of the parameter,
    or for GEGLU the concatenation of two)."""
    dim = spec.index("tp")
    if ".mlp.wi." in f".{name}":
        parts = [value.narrow(dim, s.start, s.stop - s.start) for s in wi_columns(config, tp, t)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
    block = value.shape[dim] // tp
    return value.narrow(dim, t * block, block)


class ShardParams(Mapping):
    """Shard ``(d, t)``'s parameters (name → tensor on ``mesh.devices[d][t]``):
    its slice of each tp-sharded parameter, each replicated one whole."""

    def __init__(self, sharded: "ShardedModel", d: int, t: int):
        self.sharded, self.t = sharded, t
        self.device = sharded.mesh.devices[d][t]

    def __getitem__(self, name: str) -> torch.Tensor:
        sm = self.sharded
        value, spec = sm.params[name], sm.specs[name]
        part = None
        if "tp" in spec and sm.tp > 1:
            part = self.t
            value = tp_slice(name, value, spec, sm.config, sm.tp, self.t)
        return sm.replicas.get(value, self.device, (name, part, self.device))

    def __iter__(self) -> Iterator[str]:
        return iter(self.sharded.params)

    def __len__(self) -> int:
        return len(self.sharded.params)


class DPShard:
    """One data row of a :class:`ShardedModel`, called like the model:
    ``shard(input_ids, attention_mask)`` → hidden states on the row's first
    device (`models.encoder.encoder_forward_tp` over its tp shards). A dense
    head of the model (``classifier``, ``sentence_classifier``) is an
    attribute ``(x, dtype) → logits``, as on the model."""

    def __init__(self, sharded: "ShardedModel", d: int):
        self.config = sharded.config
        self.devices = list(sharded.mesh.devices[d])
        self.params = [ShardParams(sharded, d, t) for t in range(sharded.tp)]

    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        from verbatim_rag_tpu_torch.models.encoder import encoder_forward_tp

        return encoder_forward_tp(self.params, self.devices, self.config, input_ids, attention_mask)

    def __getattr__(self, name: str):
        home = self.__dict__.get("params", [{}])[0]
        if f"{name}.kernel" not in home:
            raise AttributeError(name)
        from verbatim_rag_tpu_torch.models.encoder import dense

        return lambda x, dtype: dense(x, home[f"{name}.kernel"], home.get(f"{name}.bias"), dtype)


class ShardedModel:
    """A model placed on a ``[dp, tp]`` mesh (:func:`shard_params`).

    The model's own parameters, on ``mesh.devices[0][0]``, are the logical
    ones: ``parameters()``, ``state_dict()`` and a checkpoint are the
    unsharded model's, and an optimizer over them updates each once. Shard
    ``(d, t)`` reads its slices through a :class:`ShardParams`; the forward
    of data row d is :meth:`dp_shards`' d-th entry.
    """

    def __init__(self, model: torch.nn.Module, mesh: Mesh):
        from verbatim_rag_tpu_torch.models.encoder import ReplicaBuffers

        self.module = model
        self.mesh = mesh
        self.config = model.config
        self.tp = mesh.shape["tp"]
        self.params = dict(model.named_parameters())
        self.specs = encoder_param_specs(self.params)
        #: kept copies on devices other than the parameters' own, by
        #: (name, tp index or None, device)
        self.replicas = ReplicaBuffers()

    def parameters(self):
        return self.module.parameters()

    def named_parameters(self):
        return self.module.named_parameters()

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state):
        return self.module.load_state_dict(state)

    def dp_shards(self) -> list[DPShard]:
        """The data rows' forwards, for one forward of the whole batch (the
        kept copies are refreshed from the parameters)."""
        self.replicas.refresh()
        return [DPShard(self, d) for d in range(self.mesh.shape["dp"])]

    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        """The whole batch: rows split over dp (:func:`data_sharding`), each
        row block through its tp shards, hidden states gathered on the first
        device."""
        ids, masks = data_sharding(input_ids, self.mesh), data_sharding(attention_mask, self.mesh)
        out = [s(i, m) for s, i, m in zip(self.dp_shards(), ids, masks)]
        return torch.cat([h.to(self.mesh.devices[0][0]) for h in out])


def shard_params(model: torch.nn.Module, mesh: Mesh) -> ShardedModel:
    """Place an encoder-family model on the mesh per
    :func:`encoder_param_specs` (JAX's ``shard_params``). The model moves to
    ``mesh.devices[0][0]`` and stays the holder of the parameters.

    Raises ``ValueError`` when the heads, the hidden width or the
    intermediate width does not divide over ``tp``, as JAX's placement
    refuses an uneven cut."""
    config = model.config
    tp = mesh.shape["tp"]
    for what in ("num_heads", "hidden_size", "intermediate_size"):
        if getattr(config, what) % tp:
            raise ValueError(f"{what} ({getattr(config, what)}) does not divide evenly over tp={tp}")
    model.to(mesh.devices[0][0])
    return ShardedModel(model, mesh)
