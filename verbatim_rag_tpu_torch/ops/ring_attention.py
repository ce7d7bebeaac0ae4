"""Ring and halo attention: sequence-sharded attention over a device mesh
(port of `verbatim_rag_tpu/ops/ring_attention.py`).

A sequence-sharded array is a list of per-device chunks of dim 1, one per
device of the mesh axis (:func:`shard_sequence`). One process drives every
shard, as JAX's single-controller ``shard_map`` does: each collective of the
JAX package (``ppermute``) is a copy of a chunk to the next device of the
list, a no-op where the two are the same device.

On a mesh that spans processes (`parallel.distributed.global_mesh`) the
axis is one `parallel.mesh.AxisLine` and each rank passes only its own run
of shards, which sit at global indices ``line.first ..``: a copy between
two shards of one rank stays a device copy, and at a rank boundary the
ring's rotation is a hand-off to the next rank (`parallel.exchange.ring_shift`)
and the halos are swapped with both neighbouring ranks
(`parallel.exchange.halo_swap`), each differentiable. The step order and
the merge arithmetic are the one-process ring's, so a rank's output
shards equal the same shards of the one-process ring.

- :func:`ring_attention` is exact attention over the whole sequence: K/V
  blocks rotate around the ring and an online softmax merges each block's
  contribution, computed by `flash_attention.flash_attention_partial` (the
  CUDA kernel for CUDA shards, its plain version for CPU shards). n shards
  take n² partial calls.
- :func:`halo_attention` is ModernBERT's local attention: each shard takes
  ``window // 2`` boundary keys from each neighbour and attends with plain
  torch ops (jnp in the JAX package, which has no kernel for it).
"""

from __future__ import annotations

import torch

from verbatim_rag_tpu_torch.parallel import exchange

from .flash_attention import NEG_INF, flash_attention_partial

#: Largest [B, H, rows, keys] float32 score block :func:`halo_attention`
#: materialises at once; longer shards are taken in query chunks.
HALO_SCORE_BYTES = 1 << 30


def shard_sequence(x: torch.Tensor, mesh, axis: str = "tp") -> list[torch.Tensor]:
    """[B, S, ...] → one contiguous chunk of dim 1 per device of ``axis``
    (on a mesh that spans processes, this rank's run of them)."""
    line = mesh.line(axis)
    n = line.size
    if x.shape[1] % n != 0:
        raise ValueError(f"sequence length {x.shape[1]} must divide evenly over {n} devices")
    chunks = x.split(x.shape[1] // n, dim=1)[line.first : line.first + line.count]
    return [c.to(d).contiguous() for c, d in zip(chunks, line.devices)]


def _check_shards(shards, line, axis: str, what: str) -> None:
    if len(shards) != line.count:
        raise ValueError(f"{what}: {len(shards)} shards for {line.count} devices on mesh axis {axis!r}")


def _rotate(k_cur, v_cur, devices, line):
    """K/V one step round the ring, shard j's to shard j + 1: device copies
    inside the process, a hand-off to the next rank at its boundary (the
    previous rank's last K/V arrive at this rank's first shard)."""
    count = len(devices)
    if line.group is None:
        return (
            [k_cur[(j - 1) % count].to(devices[j]) for j in range(count)],
            [v_cur[(j - 1) % count].to(devices[j]) for j in range(count)],
        )
    kv = exchange.ring_shift(torch.stack([k_cur[-1], v_cur[-1].to(k_cur[-1].device)]), line, devices[0])
    return (
        [kv[0]] + [k_cur[j - 1].to(devices[j]) for j in range(1, count)],
        [kv[1]] + [v_cur[j - 1].to(devices[j]) for j in range(1, count)],
    )


def ring_attention(q_shards, k_shards, v_shards, lengths, mesh, axis: str = "tp"):
    """Exact attention over a sequence sharded on ``axis``: lists of
    [B, S/n, H, D] shards in, the list of output shards (q's dtype) out.

    ``lengths`` [B] are global valid lengths. K/V rotate j → j+1, so after
    step i shard ``my`` holds block ``(my − i) mod n``, which starts at
    global position ``block·S/n``. Each step's block state (numerator, max,
    denominator, float32) merges into the running state; the result is
    ``acc / max(l, 1e-20)``. K/V rotate in their own dtype (the JAX package
    casts them to float32 first, which is exact for bf16 values). Across
    processes the lists are this rank's shards, ``my`` their global index.
    """
    line = mesh.line(axis)
    _check_shards(q_shards, line, axis, "ring_attention")
    n = line.size
    shard_len = q_shards[0].shape[1]
    lengths = [lengths.to(q.device, torch.int32) for q in q_shards]
    acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in q_shards]
    m_run = [
        torch.full((q.shape[0], q.shape[2], shard_len), NEG_INF, dtype=torch.float32, device=q.device)
        for q in q_shards
    ]
    l_run = [torch.zeros_like(m) for m in m_run]
    k_cur, v_cur = list(k_shards), list(v_shards)
    for i in range(n):
        for j in range(len(q_shards)):
            owner = (line.first + j - i) % n
            numer, m_blk, l_blk = flash_attention_partial(
                q_shards[j], k_cur[j], v_cur[j], lengths[j], owner * shard_len
            )
            m_new = torch.maximum(m_run[j], m_blk)
            scale_old = torch.exp(m_run[j] - m_new)
            scale_blk = torch.exp(m_blk - m_new)
            acc[j] = (
                acc[j] * scale_old.transpose(1, 2)[..., None]
                + numer * scale_blk.transpose(1, 2)[..., None]
            )
            l_run[j] = l_run[j] * scale_old + l_blk * scale_blk
            m_run[j] = m_new
        if i + 1 < n:
            k_cur, v_cur = _rotate(k_cur, v_cur, [q.device for q in q_shards], line)
    return [
        (a / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]).to(q.dtype)
        for a, l, q in zip(acc, l_run, q_shards)
    ]


def halo_attention(q_shards, k_shards, v_shards, lengths, window: int, mesh, axis: str = "tp"):
    """Sequence-sharded LOCAL attention (attend iff |i − j| ≤ window // 2)
    by halo exchange: lists of [B, S/n, H, D] shards in and out.

    Each shard takes its left neighbour's last and its right neighbour's
    first ``window // 2`` keys; edge shards receive wrap-around halos whose
    global positions the mask kills. Scores and softmax are float32 over the
    shard's [shard + 2·halo] keys, as in the JAX package; queries are taken
    in chunks so that no score block exceeds :data:`HALO_SCORE_BYTES`.
    Requires ``S / n ≥ window // 2``. Across processes the lists are this
    rank's shards, and the halos at its boundary come from the neighbouring
    ranks.
    """
    halo = window // 2
    line = mesh.line(axis)
    n = line.size
    _check_shards(q_shards, line, axis, "halo_attention")
    shard_len = q_shards[0].shape[1]
    seq_len = shard_len * n
    if any(q.shape[1] != shard_len for q in q_shards):
        raise ValueError(
            f"halo_attention: sequence length {sum(q.shape[1] for q in q_shards)} must divide "
            f"evenly over {n} devices on mesh axis {axis!r}"
        )
    if shard_len < halo:
        raise ValueError(
            f"halo_attention requires shard length (S/n_devices = "
            f"{shard_len}) >= window//2 = {halo}; shorten the window, "
            "use fewer devices on the sequence axis, or fall back to "
            "ring_attention for this layer"
        )

    count = len(q_shards)
    if line.group is not None:  # the halos from the neighbouring ranks: [K, V] stacked
        head, tail = (k_shards[0], v_shards[0]), (k_shards[-1], v_shards[-1])
        edges = exchange.halo_swap(
            torch.stack([head[0][:, :halo], head[1][:, :halo].to(head[0].device)]),
            torch.stack([tail[0][:, shard_len - halo :], tail[1][:, shard_len - halo :].to(tail[0].device)]),
            line,
        )

    def with_halos(shards, j: int, kv: int) -> torch.Tensor:
        """Shard ``j`` between its left neighbour's last and its right
        neighbour's first ``halo`` positions, float32: [B, S/n + 2·halo, ...]."""
        dev = shards[j].device
        if line.group is None or 0 < j:
            left = shards[(j - 1) % count][:, shard_len - halo :]
        else:
            left = edges[0][kv]
        if line.group is None or j < count - 1:
            right = shards[(j + 1) % count][:, :halo]
        else:
            right = edges[1][kv]
        return torch.cat([left.to(dev), shards[j], right.to(dev)], dim=1).float()

    out = []
    for j, q in enumerate(q_shards):
        dev = q.device
        my = line.first + j
        k_ext, v_ext = with_halos(k_shards, j, 0), with_halos(v_shards, j, 1)
        k_pos = my * shard_len - halo + torch.arange(shard_len + 2 * halo, device=dev)
        key_ok = (k_pos >= 0) & (k_pos < seq_len)
        key_ok = key_ok[None, :] & (k_pos[None, :] < lengths.to(dev)[:, None])  # [B, K]
        batch, _, heads, head_dim = q.shape
        rows = max(1, HALO_SCORE_BYTES // (4 * batch * heads * k_ext.shape[1]))
        chunks = []
        for r0 in range(0, shard_len, rows):
            qc = q[:, r0 : r0 + rows].float()
            q_pos = my * shard_len + r0 + torch.arange(qc.shape[1], device=dev)
            in_band = (q_pos[:, None] - k_pos[None, :]).abs() <= halo
            valid = (in_band[None] & key_ok[:, None, :])[:, None]  # [B, 1, rows, K]
            logits = torch.einsum("bqhd,bkhd->bhqk", qc, k_ext) * (1.0 / head_dim**0.5)
            probs = torch.softmax(torch.where(valid, logits, NEG_INF), dim=-1)
            chunks.append(torch.einsum("bhqk,bkhd->bqhd", probs, v_ext))
        out.append(torch.cat(chunks, dim=1).to(q.dtype))
    return out
