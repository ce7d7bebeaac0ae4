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
:func:`shard_params` places the model as JAX does: each mesh position holds
its slices and its copies of the replicated parameters as resident leaves
on its own device (:class:`ShardedModel`), the train step sums each logical
tensor's gradient over its copies and updates every copy alike, and the
unsharded tree is gathered only when it is asked for.

A mesh may span the ranks of a ``torch.distributed`` group
(`distributed.global_mesh`, JAX's mesh over every process's devices): each
position then has a rank (:attr:`Mesh.ranks`), a process holds the
positions of its own rank only, and a collective between positions of
different ranks goes through `parallel.exchange`. A sequence axis is then
one :class:`AxisLine` of positions, of which a rank holds a contiguous run;
a tp row whose positions lie on several ranks runs the encoder's root
design across them (`exchange.TPRow`).
"""

from __future__ import annotations

from typing import Iterator

import torch

from verbatim_rag_tpu_torch.device import resolve_device

from . import distributed


class Mesh:
    """A ``[dp, tp]`` grid of devices with named axes ``("dp", "tp")``.

    ``shape`` maps each axis name to its size, as JAX's ``Mesh.shape`` does.
    ``ranks`` is the grid of the process ranks that hold the positions
    (every position this process's ``rank`` by default). On a mesh that
    spans processes, ``devices`` holds None at the positions of other ranks
    and ``groups`` maps each set of ranks a line of the mesh lies on (a
    sorted tuple) to its process group.
    """

    axis_names = ("dp", "tp")

    def __init__(self, grid: list[list[torch.device]], ranks=None, rank: int = 0, groups=None):
        self.devices = [list(row) for row in grid]
        self.shape = {"dp": len(self.devices), "tp": len(self.devices[0]) if self.devices else 0}
        self.rank = rank
        self.ranks = [list(r) for r in ranks] if ranks is not None else [[rank] * len(r) for r in self.devices]
        self.groups = dict(groups or {})

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
        sequence sharded over ``axis`` lives (on a mesh of one process)."""
        if axis == "tp":
            return list(self.devices[0])
        if axis == "dp":
            return [row[0] for row in self.devices]
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {self.axis_names}")

    @property
    def spans_processes(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)

    def is_local(self, d: int, t: int) -> bool:
        return self.ranks[d][t] == self.rank

    def local_positions(self) -> list[tuple[int, int]]:
        """This rank's positions (d, t), dp-major."""
        return [(d, t) for d in range(self.shape["dp"]) for t in range(self.shape["tp"]) if self.is_local(d, t)]

    def local_rows(self) -> list[int]:
        """The dp rows in which this rank holds a position."""
        return sorted({d for d, _ in self.local_positions()})

    def row_device(self, d: int) -> torch.device:
        """The device of this rank's first position in dp row ``d``."""
        return next(self.devices[d][t] for t in range(self.shape["tp"]) if self.is_local(d, t))

    def group(self, ranks) -> object | None:
        """The process group of a set of ranks, None when it is one rank."""
        key = tuple(sorted(set(ranks)))
        return self.groups[key] if len(key) > 1 else None

    def axis_group(self, axis: str, index: int) -> object | None:
        """The process group of the line of ``axis`` at ``index`` of the
        other axis (a tp row, or a dp column), None when it lies in one rank."""
        if axis == "tp":
            return self.group(self.ranks[index])
        if axis == "dp":
            return self.group([row[index] for row in self.ranks])
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are {self.axis_names}")

    def line(self, axis: str = "tp") -> "AxisLine":
        """The line of ``axis`` through this rank's first position."""
        return AxisLine(self, axis)


class AxisLine:
    """One line of positions along a mesh axis, and this rank's part of it:
    the ``count`` positions from index ``first`` of ``size``, on
    ``devices``; ``group`` is the line's process group (None when the line
    lies in this process), ``prev_rank`` and ``next_rank`` the ranks of the
    positions before and after this rank's run, round the ring."""

    def __init__(self, mesh: Mesh, axis: str):
        if axis not in mesh.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are {mesh.axis_names}")
        d0, t0 = mesh.local_positions()[0]
        cells = [(d0, t) for t in range(mesh.shape["tp"])] if axis == "tp" else [
            (d, t0) for d in range(mesh.shape["dp"])
        ]
        ranks = [mesh.ranks[d][t] for d, t in cells]
        local = [j for j, r in enumerate(ranks) if r == mesh.rank]
        self.size, self.first, self.count = len(cells), local[0], len(local)
        if local != list(range(self.first, self.first + self.count)):
            raise ValueError(f"rank {mesh.rank} holds positions {local} of the {axis} line, not a contiguous run")
        self.devices = [mesh.devices[d][t] for d, t in cells[self.first : self.first + self.count]]
        self.group = mesh.group(ranks)
        self.prev_rank = ranks[(self.first - 1) % self.size]
        self.next_rank = ranks[(self.first + self.count) % self.size]


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

    In a process group the array may be one rank's block of rows that span
    the group (`sharded_search.shard_rows`): ``rank`` of ``ranks`` blocks,
    in rank order. Its shards, shape and row indices are then the block's
    own; the searches of `sharded_search` place it in the group's order.
    """

    def __init__(self, shards: list[torch.Tensor], rank: int = 0, ranks: int = 1):
        self.shards = list(shards)
        self.rows_per_shard = self.shards[0].shape[0]
        if any(s.shape[0] != self.rows_per_shard for s in self.shards):
            raise ValueError("every shard must hold the same number of rows")
        self.rank, self.ranks = rank, ranks

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
        """Device bytes of the shards, rows at their pitch (`resident_bytes`)."""
        from verbatim_rag_tpu_torch.ops.fused_topk import resident_bytes

        return sum(resident_bytes(s) for s in self.shards)

    def map(self, fn, *others: "RowSharded") -> "RowSharded":
        """``fn`` applied shard by shard (to this array's shard and each of
        ``others``' shard at the same index)."""
        return RowSharded(
            [fn(s, *(o.shards[i] for o in others)) for i, s in enumerate(self.shards)],
            self.rank, self.ranks,
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
    On a mesh that spans processes ``x`` is the global batch and each rank
    keeps the shards of its own dp rows (`Mesh.local_rows`), on its first
    device in the row. Raises ``ValueError`` when B does not divide, as
    JAX's placement does."""
    dp = mesh.shape["dp"]
    if x.shape[0] % dp:
        raise ValueError(f"batch of {x.shape[0]} rows does not divide evenly over dp={dp}")
    n = x.shape[0] // dp
    return [x[d * n : (d + 1) * n].to(mesh.row_device(d)) for d in mesh.local_rows()]


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


def tp_columns(name: str, value: torch.Tensor, spec: tuple, config, tp: int, t: int) -> list[slice]:
    """Shard t's blocks of a ``"tp"``-spec parameter's sharded dim, in the
    order its slice holds them: one contiguous block, or wi's
    :func:`wi_columns`."""
    if ".mlp.wi." in f".{name}":
        return wi_columns(config, tp, t)
    block = value.shape[spec.index("tp")] // tp
    return [slice(t * block, (t + 1) * block)]


def tp_slice(name: str, value: torch.Tensor, spec: tuple, config, tp: int, t: int) -> torch.Tensor:
    """Shard t's part of a parameter with a ``"tp"`` spec (:func:`tp_columns`
    of the sharded dim): a view of the parameter, or for GEGLU's wi the
    concatenation of two."""
    dim = spec.index("tp")
    parts = [value.narrow(dim, s.start, s.stop - s.start) for s in tp_columns(name, value, spec, config, tp, t)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def grad_sum(grads: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The copies' gradients summed in list order on ``device``."""
    total = grads[0].to(device)
    for g in grads[1:]:
        total = total + g.to(device)
    return total


class DPShard:
    """One data row of a :class:`ShardedModel`, called like the model:
    ``shard(input_ids, attention_mask)`` → hidden states on the row's first
    device (`models.encoder.encoder_forward_tp` over its tp positions'
    leaves). A dense head of the model (``classifier``,
    ``sentence_classifier``) is an attribute ``(x, dtype) → logits``, as on
    the model, on the row's ``(d, 0)`` copy.

    Where the row's positions lie on several ranks (``row``, an
    `exchange.TPRow`), this rank holds the leaves of its own positions
    only: the rank of ``(d, 0)`` (the root) runs the forward and the head,
    the others follow it (`models.encoder.encoder_follow_tp`), and
    :meth:`logits` gives every rank of the row the root's logits."""

    def __init__(self, sharded: "ShardedModel", d: int):
        from .exchange import TPRow

        mesh = sharded.mesh
        self.config = sharded.config
        ts = [t for t in range(sharded.tp) if mesh.is_local(d, t)]
        self.devices = [mesh.devices[d][t] for t in ts]
        self.params = [sharded.leaves[d][t] for t in ts]
        self.row = TPRow(mesh, d) if mesh.axis_group("tp", d) is not None else None

    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        from verbatim_rag_tpu_torch.models.encoder import encoder_forward_tp

        return encoder_forward_tp(self.params, self.devices, self.config, input_ids, attention_mask, row=self.row)

    def logits(self, logits_fn, batch: dict) -> torch.Tensor:
        """``logits_fn(self, batch)``, the head's logits of the row. Across
        ranks the root computes them and shares them with the row (only the
        root's gradient flows back: the value is replicated); the other
        ranks run their part of the forward and receive them."""
        if self.row is None:
            return logits_fn(self, batch)
        if self.row.is_root:
            return self.row.share(logits_fn(self, batch), replicated=True)
        from verbatim_rag_tpu_torch.models.encoder import encoder_follow_tp

        token = encoder_follow_tp(self.params, self.devices, self.config, batch["attention_mask"], self.row)
        return self.row.receive(token, None, self.devices[0], replicated=True)

    def __getattr__(self, name: str):
        home = self.__dict__.get("params", [{}])[0]
        if f"{name}.kernel" not in home:
            raise AttributeError(name)
        from verbatim_rag_tpu_torch.models.encoder import dense

        return lambda x, dtype: dense(x, home[f"{name}.kernel"], home.get(f"{name}.bias"), dtype)


class ShardedModel:
    """A model placed on a ``[dp, tp]`` mesh as JAX places it (:func:`shard_params`).

    Mesh position ``(d, t)`` owns resident leaves on ``mesh.devices[d][t]``
    (:attr:`leaves`): its :func:`tp_slice` of every ``"tp"``-spec parameter
    and its own copy of every replicated one, each a tensor with
    ``requires_grad``. Leaves are keyed by position, not by device, so a
    mesh that repeats a device holds real copies there too. The forward of
    data row d is :meth:`dp_shards`' d-th entry, on row d's leaves.

    One logical tensor (a tp slice, or a replicated parameter) has a copy at
    each position of its group (:attr:`groups`): a slice at ``(d, t)`` for
    every d, a replicated parameter at every position. :meth:`sync_grads`
    sums each group's gradients and writes the sum to every copy, so that an
    optimizer over :meth:`parameters` updates every copy alike; the global
    norm is over :meth:`logical_parameters`, each logical tensor once.

    The unsharded module (:attr:`module`) lives on the host and is written
    only when asked: :meth:`gather` (also under :meth:`state_dict` and
    :meth:`named_parameters`); :meth:`load_state_dict` places again.

    On a mesh that spans processes a rank places and updates the leaves of
    its own positions only (the others are None in :attr:`leaves`);
    :meth:`sync_grads` sums a group's copies over the ranks that hold them,
    and :meth:`gather` is a collective that assembles the tree on rank 0.
    """

    def __init__(self, model: torch.nn.Module, mesh: Mesh):
        self.module = model
        self.mesh = mesh
        self.config = model.config
        self.dp, self.tp = mesh.shape["dp"], mesh.shape["tp"]
        self.specs = encoder_param_specs(model)
        positions = [(d, t) for d in range(self.dp) for t in range(self.tp)]
        #: (name, positions holding its copies, the owner first, dp-major)
        self.groups: list[tuple[str, list[tuple[int, int]]]] = []
        for name in self.specs:
            if self._sliced(name):
                self.groups += [(name, [(d, t) for d in range(self.dp)]) for t in range(self.tp)]
            else:
                self.groups.append((name, positions))
        #: position (d, t)'s leaves, name → tensor on ``mesh.devices[d][t]``
        #: (None at another rank's position)
        self.leaves: list[list[dict[str, torch.Tensor] | None]] = [
            [{} if mesh.is_local(d, t) else None for t in range(self.tp)] for d in range(self.dp)
        ]
        self._place()
        model.to("cpu")

    def _sliced(self, name: str) -> bool:
        return "tp" in self.specs[name] and self.tp > 1

    def _place(self) -> None:
        """Each local position's leaves from the module's parameters: made at
        the first placement, written in place after it (an optimizer holds
        them)."""
        with torch.no_grad():
            for name, value in self.module.named_parameters():
                for d, t in self.mesh.local_positions():
                    leaves = self.leaves[d][t]
                    src = value
                    if self._sliced(name):
                        src = tp_slice(name, value, self.specs[name], self.config, self.tp, t)
                    if name in leaves:
                        leaves[name].copy_(src)
                        continue
                    leaf = torch.empty(src.shape, dtype=src.dtype, device=self.mesh.devices[d][t])
                    leaves[name] = leaf.copy_(src).requires_grad_(value.requires_grad)

    def _row0(self, of) -> list[dict[str, torch.Tensor]] | None:
        """``of`` of row 0's leaves, by t (another rank's missing gradient as zeros): what
        the unsharded tree is assembled from. On a mesh that spans
        processes a collective: the ranks of row 0 send their positions'
        slices to rank 0, which alone gets the row (the others get None)."""
        sliced = [name for name in self.specs if self._sliced(name)]
        row, out = self.mesh.ranks[0], []
        for t in range(self.tp):
            if row[t] == self.mesh.rank:
                out.append({name: of(leaf) for name, leaf in self.leaves[0][t].items()})
            if row[t] == 0 or not sliced:
                continue
            if self.mesh.rank == row[t]:
                mine, leaves = out[-1], self.leaves[0][t]
                parts = [mine[n] if mine[n] is not None else torch.zeros_like(leaves[n]) for n in sliced]
                distributed.send(torch.cat([x.reshape(-1).float() for x in parts]), 0)
            elif self.mesh.rank == 0:
                home = self.leaves[0][0]
                flat = distributed.recv(sum(home[n].numel() for n in sliced), row[t], home[sliced[0]].device)
                parts = flat.split([home[n].numel() for n in sliced])
                out.append({n: x.view_as(home[n]).to(home[n].dtype) for n, x in zip(sliced, parts)})
        return out if self.mesh.rank == 0 else None

    def _assemble(self, into: dict[str, torch.Tensor], row0) -> None:
        """Write the unsharded tensors into ``into`` (name → tensor of the
        parameter's full shape) from ``row0`` (:meth:`_row0`): each tp slice
        put back at its :func:`tp_columns`, each replicated parameter from
        the (0, 0) copy."""
        with torch.no_grad():
            for name, dst in into.items():
                if not self._sliced(name):
                    dst.copy_(row0[0][name])
                    continue
                dim = self.specs[name].index("tp")
                for t in range(self.tp):
                    src, offset = row0[t][name], 0
                    for s in tp_columns(name, dst, self.specs[name], self.config, self.tp, t):
                        width = s.stop - s.start
                        dst.narrow(dim, s.start, width).copy_(src.narrow(dim, offset, width))
                        offset += width

    def gather(self) -> torch.nn.Module:
        """The shards written back into the unsharded module (on the host),
        which is returned; across processes every rank calls it and rank 0's
        module is written."""
        row0 = self._row0(lambda leaf: leaf.detach())
        if row0 is not None:
            self._assemble(dict(self.module.named_parameters()), row0)
        return self.module

    def logical_grads(self, device="cpu") -> dict[str, torch.Tensor]:
        """The unsharded gradient of every parameter whose owner copy holds
        one (after :meth:`sync_grads`, the summed gradient), on ``device``;
        across processes a collective whose result is rank 0's (the other
        ranks get an empty dict)."""
        row0 = self._row0(lambda leaf: leaf.grad)
        if row0 is None:
            return {}
        shapes = {name: p.shape for name, p in self.module.named_parameters()}
        into = {
            name: torch.empty(shapes[name], dtype=grad.dtype, device=device)
            for name, grad in row0[0].items()
            if grad is not None
        }
        self._assemble(into, row0)
        return into

    def parameters(self) -> Iterator[torch.Tensor]:
        """Every local position's leaves: what an optimizer updates."""
        return (leaf for d, t in self.mesh.local_positions() for leaf in self.leaves[d][t].values())

    def logical_parameters(self) -> list[torch.Tensor]:
        """Each logical tensor once, its owner copy (each tp slice at d = 0,
        each replicated parameter at (0, 0)), where this rank holds it: what
        the global norm counts."""
        return [self.leaves[d][t][name] for name, ((d, t), *_) in self.groups if self.mesh.is_local(d, t)]

    def process_group(self):
        """The process group of every rank of the mesh (None in one process)."""
        return self.mesh.group([r for row in self.mesh.ranks for r in row])

    def dp_group(self):
        """The process group a loss's counts and value are summed over: the
        ranks of this rank's dp column (each dp row once; None when the
        column lies in this process). A mesh of this process alone is
        joined along dp by the whole process group (`distributed.world`)."""
        if not self.mesh.spans_processes:
            return distributed.world()
        _, t = self.mesh.local_positions()[0]
        return self.mesh.axis_group("dp", t)

    def named_parameters(self):
        return self.gather().named_parameters()

    def state_dict(self):
        return self.gather().state_dict()

    def load_state_dict(self, state):
        result = self.module.load_state_dict(state)
        self._place()
        return result

    def sync_grads(self, reduce=None) -> None:
        """After a backward: each group's gradients (of the local copies
        that received one) summed in position order (:func:`grad_sum`) on
        the first local copy's device; where a group's copies lie on
        several ranks, those sums are summed over the ranks (one flat
        ``all_reduce`` a process group, the groups in one order on every
        rank; a rank whose copies got no gradient adds zeros); ``reduce``
        (e.g. `distributed.all_reduce_grads`) then takes the owners; the
        owner's gradient is copied to every other local copy, so every copy
        holds the same bits."""
        owners, buckets = [], {}
        for name, positions in self.groups:
            local = [(d, t) for d, t in positions if self.mesh.is_local(d, t)]
            if not local:
                continue
            copies = [self.leaves[d][t][name] for d, t in local]
            grads = [leaf.grad for leaf in copies if leaf.grad is not None]
            ranks = tuple(sorted({self.mesh.ranks[d][t] for d, t in positions}))
            if grads:
                copies[0].grad = grad_sum(grads, copies[0].device)
            elif len(ranks) > 1:
                copies[0].grad = torch.zeros_like(copies[0])
            else:
                continue
            owners.append(copies)
            if len(ranks) > 1:
                buckets.setdefault(ranks, []).append(copies[0].grad)
        for ranks in sorted(buckets):
            distributed.all_reduce_tensors(buckets[ranks], self.mesh.group(ranks))
        if reduce is not None:
            reduce([copies[0] for copies in owners])
        for copies in owners:
            for leaf in copies[1:]:
                leaf.grad = copies[0].grad.to(leaf.device, copy=True)

    def unequal_copies(self) -> list[str]:
        """``name@(d, t)`` of every local copy whose bits differ from the
        first local copy's."""
        out = []
        for name, positions in self.groups:
            local = [(d, t) for d, t in positions if self.mesh.is_local(d, t)]
            if not local:
                continue
            (d0, t0), *_ = local
            owner = self.leaves[d0][t0][name].detach()
            for d, t in local[1:]:
                if not torch.equal(self.leaves[d][t][name].detach().to(owner.device), owner):
                    out.append(f"{name}@({d}, {t})")
        return out

    def resident_bytes(self, optimizer_state=None) -> list[dict]:
        """Per local position: the bytes of its leaves, their gradients and
        their optimizer state (``optimizer_state``: a ``torch.optim`` state,
        leaf → dict of tensors)."""
        state = optimizer_state or {}

        def nbytes(tensors) -> int:
            return sum(x.numel() * x.element_size() for x in tensors if x is not None)

        rows = []
        for d, t in self.mesh.local_positions():
            leaves = self.leaves[d][t]
            kept = [v for leaf in leaves.values() for v in state.get(leaf, {}).values() if torch.is_tensor(v)]
            rows.append(dict(
                d=d, t=t, device=str(self.mesh.devices[d][t]), params=nbytes(leaves.values()),
                grads=nbytes(leaf.grad for leaf in leaves.values()), optimizer_state=nbytes(kept),
            ))
        return rows

    def dp_shards(self) -> list[DPShard]:
        """The forwards of the dp rows this rank takes part in, for one
        forward of the batch (`data_sharding`'s rows)."""
        return [DPShard(self, d) for d in self.mesh.local_rows()]

    def __call__(self, input_ids, attention_mask) -> torch.Tensor:
        """The whole batch: rows split over dp (:func:`data_sharding`), each
        row block through its tp shards, hidden states gathered on the first
        device (a mesh of this process)."""
        if self.mesh.spans_processes:
            raise ValueError("a mesh across processes runs row by row: dp_shards() and DPShard.logits")
        ids, masks = data_sharding(input_ids, self.mesh), data_sharding(attention_mask, self.mesh)
        out = [s(i, m) for s, i, m in zip(self.dp_shards(), ids, masks)]
        return torch.cat([h.to(self.mesh.devices[0][0]) for h in out])


def shard_params(model: torch.nn.Module, mesh: Mesh) -> ShardedModel:
    """Place an encoder-family model on the mesh per
    :func:`encoder_param_specs` (JAX's ``shard_params``): each position's
    slices and replicated copies become its resident leaves
    (:class:`ShardedModel`), and the model itself moves to the host.

    Raises ``ValueError`` when the heads, the hidden width or the
    intermediate width does not divide over ``tp``, as JAX's placement
    refuses an uneven cut."""
    config = model.config
    tp = mesh.shape["tp"]
    for what in ("num_heads", "hidden_size", "intermediate_size"):
        if getattr(config, what) % tp:
            raise ValueError(f"{what} ({getattr(config, what)}) does not divide evenly over tp={tp}")
    return ShardedModel(model, mesh)
