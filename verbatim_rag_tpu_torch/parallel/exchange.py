"""Hand-offs between the ranks of a process group, where a mesh spans
processes (`distributed.global_mesh`): what one process does as a copy
between devices, and JAX's ``ppermute`` and XLA's all-reduces do across
hosts.

- Sequence parallelism (`ops/ring_attention.py`): :func:`ring_shift` passes
  K/V (stacked) to the next rank of the sequence axis and takes the previous
  rank's, JAX's ring ``ppermute``; :func:`halo_swap` sends a rank's first
  and last ``window // 2`` keys and values to its left and right
  neighbours and takes theirs, JAX's halo ``ppermute``\\ s;
  :func:`gather_sequence` joins the ranks' sequence shards in axis order.
- Tensor parallelism, the encoder's root design across ranks
  (:class:`TPRow`, `models.encoder.encoder_forward_tp`): the rank of a tp
  row's first position (the root) holds the residual stream; it broadcasts
  each layer's attention and MLP input to the row's other ranks and gathers
  their partial projections back, which it sums in shard order.

Each hand-off is a ``torch.autograd.Function`` whose backward sends the
gradient the opposite way (a broadcast's backward sums the row's gradients
on the root, a gather's broadcasts them back), so the sequence-parallel
forward and the tp train step differentiate across ranks. Point-to-point
hand-offs are one ``batch_isend_irecv`` each, every rank of the line taking
part. Where the group runs CUDA tensors on gloo, every tensor is staged
through host memory (`distributed.stages_on_host`), in every case. A failed
hand-off raises.

:data:`handoffs` counts point-to-point hand-offs and broadcasts (backward
ones included), :data:`handoff_s` their host seconds (on gloo the transfer
itself; on NCCL the enqueue).
"""

from __future__ import annotations

import time

import torch

from . import distributed

#: Hand-offs made since the last reset, and their host seconds.
handoffs = 0
handoff_s = 0.0


def _dist():
    import torch.distributed as dist

    return dist


def _count(t0: float) -> None:
    global handoffs, handoff_s
    handoffs += 1
    handoff_s += time.perf_counter() - t0


def _buffer(shape, dtype, device, group) -> torch.Tensor:
    device = torch.device(device)
    on_host = device.type == "cuda" and distributed.stages_on_host(group)
    return torch.empty(shape, dtype=dtype, device="cpu" if on_host else device)


def exchange(sends, recvs, group) -> list[torch.Tensor]:
    """One ``batch_isend_irecv``: ``sends`` are (tensor, peer rank),
    ``recvs`` (shape, dtype, peer rank, device); the i-th send and the i-th
    receive of each rank carry tag i, so that two messages between one pair
    of ranks keep their roles on gloo (NCCL matches them in order).
    Returns the received tensors on their devices."""
    dist = _dist()
    t0 = time.perf_counter()
    wires = [distributed._wire(x, group) for x, _ in sends]
    bufs = [_buffer(shape, dtype, device, group) for shape, dtype, _, device in recvs]
    ops = [dist.P2POp(dist.isend, w, peer, group, i) for i, (w, (_, peer)) in enumerate(zip(wires, sends))]
    ops += [dist.P2POp(dist.irecv, b, r[2], group, i) for i, (b, r) in enumerate(zip(bufs, recvs))]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    _count(t0)
    return [b.to(r[3]) for b, r in zip(bufs, recvs)]


# -- sequence parallelism -------------------------------------------------------------


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, device):
        ctx.line, ctx.home = line, x.device
        (y,) = exchange([(x, line.next_rank)], [(x.shape, x.dtype, line.prev_rank, device)], line.group)
        return y

    @staticmethod
    def backward(ctx, g):
        line = ctx.line
        (gx,) = exchange([(g, line.prev_rank)], [(g.shape, g.dtype, line.next_rank, ctx.home)], line.group)
        return gx, None, None


def ring_shift(x: torch.Tensor, line, device) -> torch.Tensor:
    """One ring step across ranks: ``x`` (this rank's last shard's K/V) to
    the next rank of ``line`` (a `mesh.AxisLine`), the previous rank's on
    ``device`` back; the gradient goes the other way."""
    return _RingShift.apply(x, line, device)


class _HaloSwap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, first, last, line):
        ctx.line, ctx.devices = line, (first.device, last.device)
        left, right = exchange(
            [(last, line.next_rank), (first, line.prev_rank)],
            [(last.shape, last.dtype, line.prev_rank, first.device),
             (first.shape, first.dtype, line.next_rank, last.device)],
            line.group,
        )
        return left, right

    @staticmethod
    def backward(ctx, g_left, g_right):
        line = ctx.line
        g_last, g_first = exchange(
            [(g_left, line.prev_rank), (g_right, line.next_rank)],
            [(g_left.shape, g_left.dtype, line.next_rank, ctx.devices[1]),
             (g_right.shape, g_right.dtype, line.prev_rank, ctx.devices[0])],
            line.group,
        )
        return g_first, g_last, None


def halo_swap(first: torch.Tensor, last: torch.Tensor, line) -> tuple[torch.Tensor, torch.Tensor]:
    """The halo exchange across ranks: ``first`` (this rank's first shard's
    leading rows) goes to the previous rank, ``last`` (its last shard's
    trailing rows) to the next; returns (the previous rank's trailing rows,
    on ``first``'s device; the next rank's leading rows, on ``last``'s)."""
    return _HaloSwap.apply(first, last, line)


def gather_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """Each rank's [B, L] host tensor joined along dim 1 in rank order (the
    axis order of a line laid out rank-major): [B, W·L] on every rank."""
    parts = [torch.empty_like(x) for _ in range(_dist().get_world_size(group))]
    _dist().all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


# -- tensor parallelism ----------------------------------------------------------------


class TPRow:
    """One dp row of a mesh whose tp positions lie on several ranks.

    ``tp`` positions; ``local`` this rank's (a contiguous run); ``root`` the
    rank of position 0, which runs the residual stream; ``peers`` the other
    ranks with their positions, in order. On the root :meth:`share` and
    :meth:`gather`, on the other ranks :meth:`start`, :meth:`receive` and
    :meth:`send`, called in the same order on every rank of the row (one
    broadcast and one gather a sublayer), the followers' chained by a token
    so that their backward runs in the reverse order."""

    def __init__(self, mesh, d: int):
        ranks = mesh.ranks[d]
        self.tp = len(ranks)
        self.rank = mesh.rank
        self.root = ranks[0]
        self.group = mesh.axis_group("tp", d)
        self.local = [t for t, r in enumerate(ranks) if r == mesh.rank]
        self.peers = [(r, [t for t, q in enumerate(ranks) if q == r]) for r in sorted(set(ranks)) if r != self.root]

    @property
    def is_root(self) -> bool:
        return self.rank == self.root

    def _broadcast(self, x: torch.Tensor) -> None:
        """The root's ``x`` into every rank's ``x`` (a wire-ready tensor:
        on the host where the group stages CUDA tensors)."""
        t0 = time.perf_counter()
        _dist().broadcast(x, self.root, group=self.group)
        _count(t0)

    # root side

    def share(self, x: torch.Tensor, replicated: bool = False) -> torch.Tensor:
        """``x`` (float32) broadcast from the root to the row. Its backward
        sums the row's gradients onto the root's, in shard order; a
        ``replicated`` value (the head's logits, which every rank of the row
        turns into the same loss) keeps the root's gradient alone, and its
        shape goes first."""
        if replicated:
            header = torch.zeros(8, dtype=torch.int64)
            header[0] = x.dim()
            header[1 : 1 + x.dim()] = torch.tensor(x.shape)
            _dist().broadcast(header, self.root, group=self.group)
        return _Share.apply(x, self, replicated)

    def gather(self, anchor: torch.Tensor, partials: list[torch.Tensor]) -> list[torch.Tensor]:
        """The row's partials in shard order: the root's own ``partials``,
        then each peer's received on the root's first device. ``anchor`` is
        the shared input they were made from: the gather's backward (the
        partials' gradient sent to the peers) runs before the share's."""
        remote = _Gather.apply(anchor, self, tuple(partials[0].shape), partials[0].device)
        return list(partials) + list(remote)

    # follower side

    def start(self, device) -> torch.Tensor:
        """The first token of a follower's chain."""
        return torch.zeros((), device=device, requires_grad=torch.is_grad_enabled())

    def receive(self, token: torch.Tensor, shape, device, replicated: bool = False) -> torch.Tensor:
        """The root's :meth:`share` of the same step, on ``device`` (``shape``
        None: read from the header of a ``replicated`` value); its backward
        sends the gradient to the root, but a ``replicated`` value's."""
        if replicated:
            header = torch.zeros(8, dtype=torch.int64)
            _dist().broadcast(header, self.root, group=self.group)
            shape = tuple(header[1 : 1 + int(header[0])].tolist())
        return _Receive.apply(token, self, tuple(shape), device, replicated)

    def send(self, partials: list[torch.Tensor]) -> torch.Tensor:
        """This rank's partials to the root's :meth:`gather`; returns the
        next token. Its backward receives the partials' gradient."""
        return _Send.apply(self, *partials)


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row, replicated):
        ctx.row, ctx.replicated = row, replicated
        row._broadcast(distributed._wire(x, row.group))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        row = ctx.row
        if ctx.replicated:
            return g, None, None
        grads = exchange([], [(g.shape, g.dtype, peer, g.device) for peer, _ in row.peers], row.group)
        total = g
        for x in grads:
            total = total + x
        return total, None, None


class _Receive(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token, row, shape, device, replicated):
        ctx.row, ctx.replicated = row, replicated
        x = _buffer(shape, torch.float32, device, row.group)
        row._broadcast(x)
        return x.to(device)

    @staticmethod
    def backward(ctx, g):
        row = ctx.row
        if not ctx.replicated:
            exchange([(g, row.root)], [], row.group)
        return torch.zeros((), device=g.device), None, None, None, None


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, *partials):
        ctx.row, ctx.shape, ctx.devices = row, (len(partials), *partials[0].shape), [p.device for p in partials]
        exchange([(torch.stack([p.to(partials[0].device) for p in partials]), row.root)], [], row.group)
        return torch.zeros((), device=partials[0].device)

    @staticmethod
    def backward(ctx, g_token):
        row = ctx.row
        (grads,) = exchange([], [(ctx.shape, torch.float32, row.root, ctx.devices[0])], row.group)
        return (None, *(x.to(dev) for x, dev in zip(grads.unbind(0), ctx.devices)))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, row, shape, device):
        ctx.row = row
        got = exchange([], [((len(ts), *shape), torch.float32, peer, device) for peer, ts in row.peers], row.group)
        return tuple(x.clone() for stacked in got for x in stacked.unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        row = ctx.row
        sends, i = [], 0
        for peer, ts in row.peers:
            sends.append((torch.stack(grads[i : i + len(ts)]), peer))
            i += len(ts)
        exchange(sends, [], row.group)
        return None, None, None, None
