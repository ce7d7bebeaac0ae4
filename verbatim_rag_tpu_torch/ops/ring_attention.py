"""Ring and halo attention: sequence-sharded attention over a device mesh
(port of `verbatim_rag_tpu/ops/ring_attention.py`).

A sequence-sharded array is a list of per-device chunks of dim 1, one per
device of the mesh axis (:func:`shard_sequence`). One process drives every
shard, as JAX's single-controller ``shard_map`` does: each collective of the
JAX package (``ppermute``) is a copy of a chunk to the next device of the
list, a no-op where the two are the same device.

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

from .flash_attention import NEG_INF, flash_attention_partial

#: Largest [B, H, rows, keys] float32 score block :func:`halo_attention`
#: materialises at once; longer shards are taken in query chunks.
HALO_SCORE_BYTES = 1 << 30


def shard_sequence(x: torch.Tensor, mesh, axis: str = "tp") -> list[torch.Tensor]:
    """[B, S, ...] → one contiguous chunk of dim 1 per device of ``axis``."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if x.shape[1] % n != 0:
        raise ValueError(f"sequence length {x.shape[1]} must divide evenly over {n} devices")
    return [c.to(d).contiguous() for c, d in zip(x.split(x.shape[1] // n, dim=1), devices)]


def _check_shards(shards, mesh, axis: str, what: str) -> None:
    n = mesh.shape[axis]
    if len(shards) != n:
        raise ValueError(f"{what}: {len(shards)} shards for {n} devices on mesh axis {axis!r}")


def ring_attention(q_shards, k_shards, v_shards, lengths, mesh, axis: str = "tp"):
    """Exact attention over a sequence sharded on ``axis``: lists of
    [B, S/n, H, D] shards in, the list of output shards (q's dtype) out.

    ``lengths`` [B] are global valid lengths. K/V rotate j → j+1, so after
    step i shard ``my`` holds block ``(my − i) mod n``, which starts at
    global position ``block·S/n``. Each step's block state (numerator, max,
    denominator, float32) merges into the running state; the result is
    ``acc / max(l, 1e-20)``. K/V rotate in their own dtype (the JAX package
    casts them to float32 first, which is exact for bf16 values).
    """
    _check_shards(q_shards, mesh, axis, "ring_attention")
    n = len(q_shards)
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
        for my in range(n):
            owner = (my - i) % n
            numer, m_blk, l_blk = flash_attention_partial(
                q_shards[my], k_cur[my], v_cur[my], lengths[my], owner * shard_len
            )
            m_new = torch.maximum(m_run[my], m_blk)
            scale_old = torch.exp(m_run[my] - m_new)
            scale_blk = torch.exp(m_blk - m_new)
            acc[my] = (
                acc[my] * scale_old.transpose(1, 2)[..., None]
                + numer * scale_blk.transpose(1, 2)[..., None]
            )
            l_run[my] = l_run[my] * scale_old + l_blk * scale_blk
            m_run[my] = m_new
        if i + 1 < n:  # rotate K/V to the next device of the ring
            k_cur = [k_cur[(j - 1) % n].to(q_shards[j].device) for j in range(n)]
            v_cur = [v_cur[(j - 1) % n].to(q_shards[j].device) for j in range(n)]
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
    Requires ``S / n ≥ window // 2``.
    """
    halo = window // 2
    n = mesh.shape[axis]
    _check_shards(q_shards, mesh, axis, "halo_attention")
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

    def with_halos(shards, my: int) -> torch.Tensor:
        """Shard ``my`` between its left neighbour's last and its right
        neighbour's first ``halo`` positions, float32: [B, S/n + 2·halo, ...]."""
        dev = shards[my].device
        left, right = shards[(my - 1) % n], shards[(my + 1) % n]
        parts = [left[:, shard_len - halo :].to(dev), shards[my], right[:, :halo].to(dev)]
        return torch.cat(parts, dim=1).float()

    out = []
    for my, q in enumerate(q_shards):
        dev = q.device
        k_ext, v_ext = with_halos(k_shards, my), with_halos(v_shards, my)
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
