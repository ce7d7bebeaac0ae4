"""Transformer encoder (BERT + ModernBERT families) as an ``nn.Module``
(port of `verbatim_rag_tpu/models/encoder.py`).

Parameters keep the JAX package's names and layouts — dense kernels are
``[in, out]``, one submodule per layer instead of a stacked leading axis —
so a JAX parameter tree converts with a reshape (`highlighter.params_from_jax`).

Numerics follow the JAX forward:

- parameters live in float32; matmul operands are cast to
  ``config.compute_dtype`` and the product is float32 (`ops.dense.matmul_f32`),
  so the residual stream stays float32;
- layer norms (population variance) and softmax run in float32;
- RoPE is the half-split convention with float32 angles and the rotation in
  the compute dtype; global layers use ``global_rope_theta``, local layers
  ``local_rope_theta`` and a ``local_attention_window`` band;
- GELU is the exact erf form;
- with ``config.use_flash_attention`` every attention layer goes through
  `ops.flash_attention.flash_attention` (the CUDA kernel for CUDA tensors,
  its plain version for CPU tensors); without it, as in the JAX forward,
  attention is plain array math on any device and at any head dim:
  :func:`attention` over the additive bias of :func:`build_bias` (padding
  mask, plus the local band on local layers).

The forward is written once over parameter mappings (name → tensor, the
``state_dict`` names). :func:`encoder_forward_tp` runs it for one data row
of a mesh whose ``tp`` shards each hold their slices of the attention and
MLP weights as resident leaves on their own devices (`parallel.mesh.shard_params`),
so only activations cross devices: each shard runs its heads and its
part of the MLP, and the partial o- and wo-projections are summed over the
shards in order, their biases added once after the sum. ``Encoder.forward``
is the same function with one shard holding everything.
:func:`encoder_forward_packed` is the single-device forward over the live
tokens of prefix-masked rows alone (:func:`pack_rows`), attention on a
zeroed padded view. :func:`encoder_forward_sp` is the sequence-parallel forward over a mesh: ring
attention on global layers, halo attention on local ones.

:func:`embed_texts` is the dense provider's forward (masked mean pooling,
then L2 normalisation).
"""

from __future__ import annotations

import weakref
from typing import Iterator, Mapping, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from verbatim_rag_tpu_torch.ops.dense import matmul_f32
from verbatim_rag_tpu_torch.ops.flash_attention import flash_attention
from verbatim_rag_tpu_torch.ops.ring_attention import halo_attention, ring_attention
from verbatim_rag_tpu_torch.parallel import distributed

from .config import EncoderConfig


def compute_dtype(config: EncoderConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def _normal(shape, generator, scale=0.02) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=generator) * scale)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias, dtype: torch.dtype) -> torch.Tensor:
    """``x @ kernel (+ bias)``: operands in ``dtype``, float32 result."""
    lead = x.shape[:-1]
    y = matmul_f32(x.reshape(-1, x.shape[-1]).to(dtype), kernel.to(dtype))
    y = y.reshape(*lead, -1)
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """Float32 LayerNorm with the population variance."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale
    return y if bias is None else y + bias


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)`` with a float32 result; kernel is [in, out]."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool, generator=None):
        super().__init__()
        self.kernel = _normal((d_in, d_out), generator)
        self.bias = nn.Parameter(torch.zeros(d_out)) if use_bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(x, self.kernel, self.bias, dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, use_bias: bool = True):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, eps)


def rope_tables(theta: float, positions: torch.Tensor, head_dim: int, dtype: torch.dtype):
    """cos and sin [S, 1, D/2] of :func:`rope` at ``positions`` [S]: float32
    angles, cast to ``dtype``."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) * 2.0 / head_dim
    denom = torch.tensor(theta, dtype=torch.float32, device=positions.device) ** exponent
    freq = positions[:, None].float() / denom  # [S, half]
    return torch.cos(freq).to(dtype)[:, None, :], torch.sin(freq).to(dtype)[:, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., S, H, D] by tables of :func:`rope_tables` (half-split)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, theta: float, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over head_dim of [B, S, H, D] (half-split convention)."""
    return apply_rope(x, *rope_tables(theta, positions, x.shape[-1], x.dtype))


#: Additive bias of masked-out keys (the JAX encoder's ``NEG_INF``).
NEG_INF = -1e30


def attention(q, k, v, bias) -> torch.Tensor:
    """Plain attention over [B, S, H, D] in the compute dtype: float32
    logits (scaled by 1/√D) plus ``bias`` [B, 1, S, S], float32 softmax,
    probabilities cast to v's dtype, float32 output [B, S, H, D]. Products
    of bf16 operands are exact in float32, so both products run on float32
    copies (the float32 accumulation XLA's ``preferred_element_type``
    asks for)."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * scale.to(logits.device) + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())


def build_bias(attention_mask, seq_len: int, is_global: bool, window: int) -> torch.Tensor:
    """Additive attention bias [B, 1, S, S]: ``NEG_INF`` on padded keys, and
    on local layers on keys farther than ``window // 2`` from the query."""
    pad = (1.0 - attention_mask.float())[:, None, None, :] * NEG_INF
    idx = torch.arange(seq_len, device=attention_mask.device)
    dist = (idx[:, None] - idx[None, :]).abs()
    local = torch.where(dist <= window // 2, 0.0, NEG_INF)[None, None]
    return pad + (0.0 if is_global else 1.0) * local


class EncoderLayer(nn.Module):
    def __init__(self, config: EncoderConfig, generator=None):
        super().__init__()
        h = config.hidden_size
        bias = config.use_bias
        ln_bias = config.use_bias or config.norm_location == "post"
        wi_out = 2 * config.intermediate_size if config.activation == "geglu" else config.intermediate_size
        self.attn = nn.ModuleDict(
            {name: Dense(h, h, bias, generator) for name in ("q", "k", "v", "o")}
        )
        self.attn_ln = LayerNorm(h, ln_bias)
        self.mlp = nn.ModuleDict(
            {
                "wi": Dense(h, wi_out, bias, generator),
                "wo": Dense(config.intermediate_size, h, bias, generator),
            }
        )
        self.mlp_ln = LayerNorm(h, ln_bias)


# -- the forward over parameter mappings ---------------------------------------------


def embed(p: Mapping, config: EncoderConfig, input_ids, token_type_ids=None, positions=None):
    """Token (+ absolute position, + token type) embeddings; ``positions``
    default to ``arange(S)`` (a sequence shard passes its global ones)."""
    emb = p["embeddings.word"][input_ids]
    if config.position_embedding_type == "absolute":
        if positions is None:
            positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = emb + p["embeddings.position"][positions][None]
    if config.type_vocab_size and "embeddings.token_type" in p:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = emb + p["embeddings.token_type"][token_type_ids]
    if config.embedding_norm:
        emb = _norm(p, "embeddings_ln", emb, config.layer_norm_eps)
    return emb


def _norm(p: Mapping, name: str, x, eps: float):
    return layer_norm(x, p[f"{name}.scale"], p.get(f"{name}.bias"), eps)


def _attn_in(p: Mapping, config: EncoderConfig, i: int, h):
    """Layer i's attention input: its pre-norm, except ModernBERT's layer 0."""
    if config.norm_location == "pre" and not (i == 0 and config.first_layer_no_attn_norm):
        return _norm(p, f"layers.{i}.attn_ln", h, config.layer_norm_eps)
    return h


def _qkv(p: Mapping, pre: str, x, dtype, heads: int, head_dim: int, cols: slice):
    """q, k, v [B, S, heads, D] from ``p``'s kernels; ``cols`` picks the
    shard's heads from a replicated bias."""
    out = []
    for name in ("q", "k", "v"):
        bias = p.get(f"{pre}attn.{name}.bias")
        y = dense(x, p[f"{pre}attn.{name}.kernel"], None if bias is None else bias[cols], dtype)
        out.append(y.reshape(*x.shape[:2], heads, head_dim))
    return out


def _attend(q, k, v, config: EncoderConfig, is_global: bool, positions, lengths, attention_mask):
    """RoPE, then flash or plain attention over [B, S, H, D]."""
    dtype = compute_dtype(config)
    use_rope = config.position_embedding_type == "rope"
    if use_rope:
        theta = config.global_rope_theta if is_global else config.local_rope_theta
        q = rope(q.to(dtype), theta, positions)
        k = rope(k.to(dtype), theta, positions)
    bias = None
    if not config.use_flash_attention:
        bias = build_bias(
            attention_mask, q.shape[1], is_global or not use_rope, config.local_attention_window
        )
    return _attention(q, k, v, config, is_global, lengths, bias)


def _attention(q, k, v, config: EncoderConfig, is_global: bool, lengths, bias):
    """Flash attention over [B, S, H, D] with the rows' ``lengths`` (through
    the module's name ``flash_attention``), or with flash off plain
    attention over ``bias`` (:func:`build_bias`)."""
    dtype = compute_dtype(config)
    if config.use_flash_attention:
        use_rope = config.position_embedding_type == "rope"
        window = None if is_global or not use_rope else config.local_attention_window
        return flash_attention(
            q.to(dtype).contiguous(), k.to(dtype).contiguous(), v.to(dtype).contiguous(),
            lengths, window,
        )
    return attention(q.to(dtype), k.to(dtype), v.to(dtype), bias)


def _mlp(p: Mapping, pre: str, x, activation: str, dtype, wo_bias: bool = False):
    """The MLP; without wo's bias (the default) a tp shard's partial sum."""
    up = dense(x, p[f"{pre}mlp.wi.kernel"], p.get(f"{pre}mlp.wi.bias"), dtype)
    if activation == "geglu":
        gate, val = up.chunk(2, dim=-1)
        hidden = F.gelu(gate.to(dtype), approximate="none") * val.to(dtype)
    else:
        hidden = F.gelu(up.to(dtype), approximate="none")
    return dense(hidden, p[f"{pre}mlp.wo.kernel"], p.get(f"{pre}mlp.wo.bias") if wo_bias else None, dtype)


def tp_reduce(partials: Sequence[torch.Tensor], bias, device) -> torch.Tensor:
    """The tp shards' partial projections summed in shard order onto
    ``device``, then the replicated bias added once."""
    out = partials[0].to(device)
    for x in partials[1:]:
        out = out + x.to(device)
    return out if bias is None else out + bias


def _attn_partial(p: Mapping, pre: str, x, config: EncoderConfig, i: int, t: int, heads: int, position, length, mask):
    """Shard t's part of layer i's attention: its ``heads`` heads (q/k/v,
    RoPE, attention) and their rows of the o-projection, without o's bias."""
    dtype = compute_dtype(config)
    width = heads * config.head_dim
    q, k, v = _qkv(p, pre, x, dtype, heads, config.head_dim, slice(t * width, (t + 1) * width))
    ctx = _attend(q, k, v, config, config.is_global_layer(i), position, length, mask)
    return dense(ctx.reshape(*x.shape[:2], width), p[f"{pre}attn.o.kernel"], None, dtype)


def encoder_forward_tp(
    params: Sequence[Mapping], devices, config: EncoderConfig, input_ids, attention_mask,
    token_type_ids=None, row=None,
) -> torch.Tensor:
    """The encoder forward for one data row of a ``[dp, tp]`` mesh:
    ``params[t]`` maps the ``state_dict`` names to shard t's tensors on
    ``devices[t]`` (its column block of q/k/v and wi, its row block of o and
    wo, the rest whole), inputs on ``devices[0]`` → hidden states [B, S,
    hidden] float32 on ``devices[0]``.

    Embeddings, norms and the residual stream run on ``devices[0]``; each
    shard runs its ``num_heads / tp`` heads (q/k/v, RoPE, attention, its part
    of the o-projection) and its part of the MLP; :func:`tp_reduce` sums the
    partials. One shard holding every parameter is the single-device forward.

    Where the row's positions lie on several ranks, ``row`` is its
    `parallel.exchange.TPRow` and this is the root's side: ``params`` and
    ``devices`` are the root's own positions (0 .. k − 1), each sublayer's
    input goes to the other ranks by a broadcast (`TPRow.share`) and their
    partials come back (`TPRow.gather`), summed with the root's in shard
    order; the other ranks run :func:`encoder_follow_tp`.
    """
    tp = len(params) if row is None else row.tp
    dtype = compute_dtype(config)
    batch, seq_len = input_ids.shape
    heads = config.num_heads // tp
    home = params[0]
    positions = [torch.arange(seq_len, device=d) for d in devices]
    lengths = attention_mask.sum(dim=1).to(torch.int32)
    lengths = [lengths.to(d) for d in devices]
    masks = [attention_mask.to(d) for d in devices]

    def reduce(x, partials, bias):
        if row is not None:
            partials = row.gather(x, partials)
        return tp_reduce(partials, bias, devices[0])

    def attend(i: int, a_in):
        a_in = a_in if row is None else row.share(a_in)
        partials = [
            _attn_partial(p, f"layers.{i}.", a_in.to(dev), config, i, t, heads, positions[t], lengths[t], masks[t])
            for t, (p, dev) in enumerate(zip(params, devices))
        ]
        return reduce(a_in, partials, home.get(f"layers.{i}.attn.o.bias"))

    def mlp(i: int, m_in):
        m_in = m_in if row is None else row.share(m_in)
        partials = [_mlp(p, f"layers.{i}.", m_in.to(dev), config.activation, dtype) for p, dev in zip(params, devices)]
        return reduce(m_in, partials, home.get(f"layers.{i}.mlp.wo.bias"))

    return _layers(home, config, embed(home, config, input_ids.long(), token_type_ids), attend, mlp)


def _layers(p: Mapping, config: EncoderConfig, h, attend, mlp) -> torch.Tensor:
    """The residual layer stack from the embeddings ``h`` → hidden states
    float32: ``p``'s norms (pre- or post-norm, then the final norm) around
    ``attend(i, a_in)`` and ``mlp(i, m_in)``, layer i's attention and MLP
    outputs with their o- and wo-biases."""
    pre_ln = config.norm_location == "pre"
    eps = config.layer_norm_eps
    for i in range(config.num_layers):
        pre = f"layers.{i}."
        h = h + attend(i, _attn_in(p, config, i, h))
        if not pre_ln:
            h = _norm(p, f"{pre}attn_ln", h, eps)
        m_in = _norm(p, f"{pre}mlp_ln", h, eps) if pre_ln else h
        h = h + mlp(i, m_in)
        if not pre_ln:
            h = _norm(p, f"{pre}mlp_ln", h, eps)
    if config.final_norm:
        h = _norm(p, "final_ln", h, eps)
    return h.float()


def encoder_follow_tp(params: Sequence[Mapping], devices, config: EncoderConfig, attention_mask, row) -> torch.Tensor:
    """A non-root rank's side of :func:`encoder_forward_tp` on a tp row
    across ranks (``row``, a `parallel.exchange.TPRow`): ``params[j]`` and
    ``devices[j]`` are its positions ``row.local[j]``. Each sublayer it
    receives the root's input (`TPRow.receive`), runs its positions' heads
    or MLP part and sends the partials (`TPRow.send`). Returns the last
    token of the chain, which `TPRow.receive` of the row's logits takes."""
    dtype = compute_dtype(config)
    heads = config.num_heads // row.tp
    batch, seq_len = attention_mask.shape
    shape = (batch, seq_len, config.hidden_size)
    positions = [torch.arange(seq_len, device=d) for d in devices]
    lengths = [attention_mask.sum(dim=1).to(torch.int32).to(d) for d in devices]
    masks = [attention_mask.to(d) for d in devices]
    token = row.start(devices[0])
    for i in range(config.num_layers):
        pre = f"layers.{i}."
        a_in = row.receive(token, shape, devices[0])
        token = row.send([
            _attn_partial(p, pre, a_in.to(dev), config, i, t, heads, positions[j], lengths[j], masks[j])
            for j, (t, p, dev) in enumerate(zip(row.local, params, devices))
        ])
        m_in = row.receive(token, shape, devices[0])
        token = row.send([_mlp(p, pre, m_in.to(dev), config.activation, dtype) for p, dev in zip(params, devices)])
    return token


#: Keys a tile of the flash forward kernel (``kFwdKeys`` in
#: `csrc/flash_attention.cu`): the packed forward's attention view is its
#: longest row rounded up to it.
VIEW_TILE = 128


class PackedRows(NamedTuple):
    """The live tokens of [B, S] rows under a prefix mask (:func:`pack_rows`)."""

    flat: np.ndarray  #: [T] the live slots' flat indices in [B, S]
    positions: np.ndarray  #: [T] each token's position in its row
    slots: np.ndarray  #: [T] its slot ``row × view_len + position`` in the attention view
    lengths: np.ndarray  #: [R] int32 live lengths of the R rows with a live token
    view_len: int  #: the longest row rounded up to VIEW_TILE, at most S


def pack_rows(mask: np.ndarray) -> PackedRows:
    """Pack the prefix ``mask`` [B, S] on the host (no device ``nonzero``)."""
    seq = mask.shape[1]
    flat = np.flatnonzero(mask)
    lengths = mask.sum(axis=1)
    live = lengths > 0
    lengths = lengths[live].astype(np.int32)
    view_len = min(seq, -(-int(lengths.max(initial=0)) // VIEW_TILE) * VIEW_TILE)
    positions = flat % seq
    view_rows = (np.cumsum(live) - 1)[flat // seq]
    return PackedRows(flat, positions, view_rows * view_len + positions, lengths, view_len)


def encoder_forward_packed(p: Mapping, config: EncoderConfig, input_ids: np.ndarray, rows: PackedRows) -> torch.Tensor:
    """The single-device forward over the live tokens alone: padded
    ``input_ids`` [B, S] and their :func:`pack_rows` (at least one token) →
    hidden states [T, hidden] float32 on ``p``'s device.

    Embeddings (each token's own position, token type 0), norms,
    projections, the MLP and the float32 residual stream run on the T tokens
    with the padded forward's arithmetic a token. For attention q, k and v
    are scattered into [R, view_len, H, D] views, attended with the rows'
    lengths (flash through the module's name ``flash_attention``, or plain
    attention over :func:`build_bias`) and the output gathered back at the
    live slots. The views are zeroed once and every layer writes the same
    slots, so their pad stays zero: the kernel loads whole key tiles, and a
    masked score times NaN in V is NaN.
    """
    dtype = compute_dtype(config)
    heads, head_dim = config.num_heads, config.head_dim
    device = p["embeddings.word"].device
    packed = np.stack([input_ids.reshape(-1)[rows.flat], rows.positions, rows.slots])
    tokens, positions, slots = torch.from_numpy(packed).to(device)
    lengths = torch.from_numpy(rows.lengths).to(device)
    count, view_len = len(rows.lengths), rows.view_len
    use_rope = config.position_embedding_type == "rope"
    views = [torch.zeros(count * view_len, heads, head_dim, dtype=dtype, device=device) for _ in range(3)]
    is_global = [config.is_global_layer(i) for i in range(config.num_layers)]
    thetas = {config.global_rope_theta if g else config.local_rope_theta for g in is_global}
    tables = {theta: rope_tables(theta, positions, head_dim, dtype) for theta in thetas} if use_rope else {}
    biases = {}
    if not config.use_flash_attention:
        mask = torch.arange(view_len, device=device)[None] < lengths[:, None]
        for full in {g or not use_rope for g in is_global}:
            biases[full] = build_bias(mask, view_len, full, config.local_attention_window)

    def attend(i: int, x):
        """Layer i's attention over ``x`` [1, T, hidden] with its o-projection;
        its temporaries are freed before the MLP runs."""
        pre = f"layers.{i}."
        qkv = _qkv(p, pre, x, dtype, heads, head_dim, slice(None))
        if use_rope:
            cos, sin = tables[config.global_rope_theta if is_global[i] else config.local_rope_theta]
            qkv[0], qkv[1] = (apply_rope(y.to(dtype), cos, sin) for y in qkv[:2])
        for view, y in zip(views, qkv):
            view.index_copy_(0, slots, y[0].to(dtype))
        del qkv
        q, k, v = (view.view(count, view_len, heads, head_dim) for view in views)
        out = _attention(q, k, v, config, is_global[i], lengths, biases.get(is_global[i] or not use_rope))
        ctx = out.reshape(count * view_len, heads * head_dim)[slots][None]
        return dense(ctx, p[f"{pre}attn.o.kernel"], p.get(f"{pre}attn.o.bias"), dtype)

    def mlp(i: int, m_in):
        return _mlp(p, f"layers.{i}.", m_in, config.activation, dtype, wo_bias=True)

    return _layers(p, config, embed(p, config, tokens[None].long(), positions=positions), attend, mlp)[0]


class Encoder(nn.Module):
    """Encoder stack: embeddings → layers → optional final LayerNorm.

    ``forward(input_ids [B, S], attention_mask [B, S])`` → hidden states
    [B, S, hidden] float32. The attention mask must be a prefix mask (valid
    tokens first), as the tokenizers produce.
    """

    def __init__(self, config: EncoderConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        embeddings = {"word": _normal((config.vocab_size, h), generator)}
        if config.position_embedding_type == "absolute":
            embeddings["position"] = _normal((config.max_position_embeddings, h), generator)
        if config.type_vocab_size:
            embeddings["token_type"] = _normal((config.type_vocab_size, h), generator)
        self.embeddings = nn.ParameterDict(embeddings)
        self.embeddings_ln = (
            LayerNorm(h, config.use_bias or config.norm_location == "post")
            if config.embedding_norm
            else None
        )
        self.layers = nn.ModuleList(
            [EncoderLayer(config, generator) for _ in range(config.num_layers)]
        )
        self.final_ln = LayerNorm(h, config.use_bias) if config.final_norm else None

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        return encoder_forward_tp(
            [dict(self.named_parameters())], [input_ids.device], self.config,
            input_ids, attention_mask, token_type_ids,
        )


# -- pooling heads ------------------------------------------------------------------


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence (sentence-transformers pooling)."""
    mask = attention_mask.float()[..., None]
    summed = torch.sum(hidden * mask, dim=1)
    counts = torch.clamp(torch.sum(mask, dim=1), min=1e-9)
    return summed / counts


def cls_pool(hidden: torch.Tensor) -> torch.Tensor:
    return hidden[:, 0, :]


def embed_texts(
    model: Encoder, input_ids: torch.Tensor, attention_mask: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Dense-embedding forward: encoder → masked mean → L2 norm (floored at
    1e-12) — [B, hidden] float32."""
    hidden = model(input_ids, attention_mask)
    pooled = mean_pool(hidden, attention_mask)
    if normalize:
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        pooled = pooled / torch.clamp(norm, min=1e-12)
    return pooled


# -- parameters on other devices -------------------------------------------------------


class _Replicate(torch.autograd.Function):
    """A kept buffer holding ``src``'s value on another device; the gradient
    that lands on it is returned to ``src``."""

    @staticmethod
    def forward(ctx, src, buffer_box):
        ctx.home = src.device
        return buffer_box[0].detach()

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.home), None


class ReplicaBuffers:
    """Kept copies of parameters on devices other than their own, by key,
    each made at its first use (`shard_replicas`).

    :meth:`refresh` starts a new forward: each buffer is copied from its
    source again at its first use after it, and once only, so that the
    forward's users of one buffer (the sequence shards on one device) share
    one copy. Parameters change in place under an optimizer (and
    torch's fused AdamW moves no version counter), so a copy is never
    trusted across forwards."""

    def __init__(self):
        self.buffers: dict = {}
        self.generation = 0

    def refresh(self) -> None:
        self.generation += 1

    def get(self, src: torch.Tensor, device, key) -> torch.Tensor:
        """``src`` on ``device``: ``src`` itself where it lives, else its
        kept buffer; under grad the buffer is linked to ``src``, so a
        gradient that lands on it reaches ``src``."""
        if src.device == device:
            return src
        buf, seen = self.buffers.get(key, (None, None))
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf, seen = torch.empty(src.shape, dtype=src.dtype, device=device), None
        if seen != self.generation:
            with torch.no_grad():
                buf.copy_(src)
            self.buffers[key] = (buf, self.generation)
        if torch.is_grad_enabled() and src.requires_grad:
            return _Replicate.apply(src, [buf])
        return buf


#: Each model's kept replicas for `shard_replicas`, by (name, device).
_REPLICAS: "weakref.WeakKeyDictionary[nn.Module, ReplicaBuffers]" = weakref.WeakKeyDictionary()


class ReplicaParams(Mapping):
    """A model's parameters as seen from one device (name → tensor): the
    parameters themselves on their own device, kept replicas
    (:class:`ReplicaBuffers`) on any other."""

    def __init__(self, model: nn.Module, device, replicas: ReplicaBuffers):
        self.device = torch.device(device)
        self._params = dict(model.named_parameters())
        self._replicas = replicas

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._replicas.get(self._params[name], self.device, (name, self.device))

    def __iter__(self) -> Iterator[str]:
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)


def shard_replicas(model: nn.Module, devices) -> list[ReplicaParams]:
    """``model``'s parameters for each shard's device of one forward
    (:class:`ReplicaParams`): the model keeps one replica per parameter and
    distinct device, a device that appears again reuses it, and a mesh of
    the model's own device reads the model's parameters with no copy."""
    replicas = _REPLICAS.setdefault(model, ReplicaBuffers())
    replicas.refresh()
    return [ReplicaParams(model, dev, replicas) for dev in devices]


def encoder_forward_sp(
    model: Encoder, ids_shards, mask_shards, mesh, axis: str = "tp", params=None
) -> list[torch.Tensor]:
    """Sequence-parallel encoder forward: lists of [B, S/n] id and mask
    shards (one per device of ``axis``, :func:`ops.ring_attention.shard_sequence`)
    → the list of hidden-state shards [B, S/n, hidden] float32.

    Activations stay on their shard's device; embeddings, LayerNorms, dense
    layers, MLP and RoPE run per shard (on :func:`shard_replicas`), RoPE and
    absolute positions at global positions ``my·S/n + arange``. Global layers
    run exact ring attention, local layers halo attention. ``lengths`` is
    the mask summed over the shards. The function is the single-device
    forward's: results match it up to float rounding, and it is
    differentiable: every shard's gradient reaches ``model``'s parameters.
    ``params`` are the shards' :func:`shard_replicas` when the caller uses
    them after the forward too (a head on the hidden states).

    On a mesh that spans processes the lists are this rank's run of the
    axis's shards (`mesh.AxisLine`): positions are global from the line's
    ``first`` index, ``lengths`` is summed over the line's ranks, and ring
    and halo attention hand K/V across the rank boundaries; each rank's
    gradients are its shards' share.
    """
    config = model.config
    dtype = compute_dtype(config)
    heads, head_dim = config.num_heads, config.head_dim
    pre_ln = config.norm_location == "pre"
    eps = config.layer_norm_eps
    use_rope = config.position_embedding_type == "rope"
    devices = [ids.device for ids in ids_shards]
    params = params or shard_replicas(model, devices)
    shard_len = ids_shards[0].shape[1]
    line = mesh.line(axis)
    positions = [(line.first + j) * shard_len + torch.arange(shard_len, device=d) for j, d in enumerate(devices)]
    lengths = sum(m.to(devices[0]).sum(dim=1) for m in mask_shards)
    if line.group is not None:
        lengths = distributed.all_reduce_(lengths, line.group)
    lengths = lengths.to(torch.int32)

    h = [embed(p, config, ids.long(), None, pos) for p, ids, pos in zip(params, ids_shards, positions)]
    for i in range(config.num_layers):
        pre = f"layers.{i}."
        is_global = config.is_global_layer(i)
        theta = config.global_rope_theta if is_global else config.local_rope_theta
        qs, ks, vs = [], [], []
        for p, x, pos in zip(params, h, positions):
            q, k, v = _qkv(p, pre, _attn_in(p, config, i, x), dtype, heads, head_dim, slice(None))
            if use_rope:
                q = rope(q.to(dtype), theta, pos)
                k = rope(k.to(dtype), theta, pos)
            qs.append(q.to(dtype).contiguous())
            ks.append(k.to(dtype).contiguous())
            vs.append(v.to(dtype).contiguous())
        if is_global:
            ctx = ring_attention(qs, ks, vs, lengths, mesh, axis)
        else:
            ctx = halo_attention(qs, ks, vs, lengths, config.local_attention_window, mesh, axis)
        for my, (p, c) in enumerate(zip(params, ctx)):
            x = h[my] + dense(c.reshape(*c.shape[:2], -1), p[f"{pre}attn.o.kernel"], p.get(f"{pre}attn.o.bias"), dtype)
            if not pre_ln:
                x = _norm(p, f"{pre}attn_ln", x, eps)
            m_in = _norm(p, f"{pre}mlp_ln", x, eps) if pre_ln else x
            x = x + _mlp(p, pre, m_in, config.activation, dtype, wo_bias=True)
            if not pre_ln:
                x = _norm(p, f"{pre}mlp_ln", x, eps)
            h[my] = x
    if config.final_norm:
        h = [_norm(p, "final_ln", x, eps) for p, x in zip(params, h)]
    return [x.float() for x in h]
