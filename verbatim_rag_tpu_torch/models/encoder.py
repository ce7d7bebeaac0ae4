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

:func:`embed_texts` is the dense provider's forward (masked mean pooling,
then L2 normalisation). :func:`encoder_forward_sp` is the sequence-parallel
forward over a mesh: ring attention on global layers, halo attention on
local ones.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from verbatim_rag_tpu_torch.ops.dense import matmul_f32
from verbatim_rag_tpu_torch.ops.flash_attention import flash_attention
from verbatim_rag_tpu_torch.ops.ring_attention import halo_attention, ring_attention

from .config import EncoderConfig


def compute_dtype(config: EncoderConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def _normal(shape, generator, scale=0.02) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=generator) * scale)


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)`` with a float32 result; kernel is [in, out]."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool, generator=None):
        super().__init__()
        self.kernel = _normal((d_in, d_out), generator)
        self.bias = nn.Parameter(torch.zeros(d_out)) if use_bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        lead = x.shape[:-1]
        y = matmul_f32(x.reshape(-1, x.shape[-1]).to(dtype), self.kernel.to(dtype))
        y = y.reshape(*lead, -1)
        if self.bias is not None:
            y = y + self.bias
        return y


class LayerNorm(nn.Module):
    def __init__(self, dim: int, use_bias: bool = True):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        x = x.float()
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps) * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y


def rope(x: torch.Tensor, theta: float, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over head_dim of [B, S, H, D] (half-split convention)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=x.device) * 2.0 / head_dim
    denom = torch.tensor(theta, dtype=torch.float32, device=x.device) ** exponent
    freq = positions[:, None].float() / denom  # [S, half]
    cos = torch.cos(freq).to(x.dtype)[None, :, None, :]
    sin = torch.sin(freq).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


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

    def mlp_forward(self, x, activation: str, dtype) -> torch.Tensor:
        up = self.mlp["wi"](x, dtype)
        if activation == "geglu":
            gate, val = up.chunk(2, dim=-1)
            hidden = F.gelu(gate.to(dtype), approximate="none") * val.to(dtype)
        else:
            hidden = F.gelu(up.to(dtype), approximate="none")
        return self.mlp["wo"](hidden, dtype)


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

    def embed(self, input_ids, token_type_ids=None, positions=None) -> torch.Tensor:
        """Token (+ absolute position, + token type) embeddings; ``positions``
        default to ``arange(S)`` (a sequence shard passes its global ones)."""
        config = self.config
        emb = self.embeddings["word"][input_ids]
        if config.position_embedding_type == "absolute":
            if positions is None:
                positions = torch.arange(input_ids.shape[1], device=input_ids.device)
            emb = emb + self.embeddings["position"][positions][None]
        if config.type_vocab_size and "token_type" in self.embeddings:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            emb = emb + self.embeddings["token_type"][token_type_ids]
        if self.embeddings_ln is not None:
            emb = self.embeddings_ln(emb, config.layer_norm_eps)
        return emb

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        config = self.config
        dtype = compute_dtype(config)
        batch, seq_len = input_ids.shape
        heads, head_dim = config.num_heads, config.head_dim
        pre_ln = config.norm_location == "pre"
        eps = config.layer_norm_eps
        use_rope = config.position_embedding_type == "rope"
        positions = torch.arange(seq_len, device=input_ids.device)
        lengths = attention_mask.sum(dim=1).to(torch.int32)

        h = self.embed(input_ids.long(), token_type_ids)
        for i, layer in enumerate(self.layers):
            is_global = config.is_global_layer(i)
            if pre_ln and not (i == 0 and config.first_layer_no_attn_norm):
                a_in = layer.attn_ln(h, eps)
            else:
                a_in = h
            q, k, v = (
                layer.attn[name](a_in, dtype).reshape(batch, seq_len, heads, head_dim)
                for name in ("q", "k", "v")
            )
            if use_rope:
                theta = config.global_rope_theta if is_global else config.local_rope_theta
                q = rope(q.to(dtype), theta, positions)
                k = rope(k.to(dtype), theta, positions)
            if config.use_flash_attention:
                window = None if is_global or not use_rope else config.local_attention_window
                ctx = flash_attention(
                    q.to(dtype).contiguous(), k.to(dtype).contiguous(),
                    v.to(dtype).contiguous(), lengths, window,
                )
            else:
                bias = build_bias(
                    attention_mask, seq_len, is_global or not use_rope,
                    config.local_attention_window,
                )
                ctx = attention(q.to(dtype), k.to(dtype), v.to(dtype), bias)
            h = h + layer.attn["o"](ctx.reshape(batch, seq_len, -1), dtype)
            if not pre_ln:
                h = layer.attn_ln(h, eps)
            m_in = layer.mlp_ln(h, eps) if pre_ln else h
            h = h + layer.mlp_forward(m_in, config.activation, dtype)
            if not pre_ln:
                h = layer.mlp_ln(h, eps)

        if self.final_ln is not None:
            h = self.final_ln(h, eps)
        return h.float()


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


def shard_replicas(model: nn.Module, devices) -> list[nn.Module]:
    """``model`` for each shard's device: the model itself where its
    parameters live, a copy elsewhere (made once per distinct device)."""
    home = next(model.parameters()).device
    copies = {home: model}
    for dev in devices:
        if dev not in copies:
            copies[dev] = copy.deepcopy(model).to(dev)
    return [copies[dev] for dev in devices]


def encoder_forward_sp(model: Encoder, ids_shards, mask_shards, mesh, axis: str = "tp") -> list[torch.Tensor]:
    """Sequence-parallel encoder forward: lists of [B, S/n] id and mask
    shards (one per device of ``axis``, :func:`ops.ring_attention.shard_sequence`)
    → the list of hidden-state shards [B, S/n, hidden] float32.

    Activations stay on their shard's device; embeddings, LayerNorms, dense
    layers, MLP and RoPE run per shard, RoPE and absolute positions at global
    positions ``my·S/n + arange``. Global layers run exact ring attention,
    local layers halo attention.
    ``lengths`` is the mask summed over the shards. The function is the
    single-device forward's: results match it up to float rounding.
    """
    config = model.config
    dtype = compute_dtype(config)
    heads, head_dim = config.num_heads, config.head_dim
    pre_ln = config.norm_location == "pre"
    eps = config.layer_norm_eps
    use_rope = config.position_embedding_type == "rope"
    devices = [ids.device for ids in ids_shards]
    models = shard_replicas(model, devices)
    shard_len = ids_shards[0].shape[1]
    positions = [my * shard_len + torch.arange(shard_len, device=d) for my, d in enumerate(devices)]
    lengths = sum(m.to(devices[0]).sum(dim=1) for m in mask_shards).to(torch.int32)

    h = [md.embed(ids.long(), None, pos) for md, ids, pos in zip(models, ids_shards, positions)]
    for i in range(config.num_layers):
        is_global = config.is_global_layer(i)
        theta = config.global_rope_theta if is_global else config.local_rope_theta
        qs, ks, vs = [], [], []
        for md, x, pos in zip(models, h, positions):
            layer = md.layers[i]
            a_in = layer.attn_ln(x, eps) if pre_ln and not (i == 0 and config.first_layer_no_attn_norm) else x
            batch, seq = x.shape[:2]
            q, k, v = (
                layer.attn[name](a_in, dtype).reshape(batch, seq, heads, head_dim)
                for name in ("q", "k", "v")
            )
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
        for my, (md, c) in enumerate(zip(models, ctx)):
            layer = md.layers[i]
            x = h[my] + layer.attn["o"](c.reshape(*c.shape[:2], -1), dtype)
            if not pre_ln:
                x = layer.attn_ln(x, eps)
            m_in = layer.mlp_ln(x, eps) if pre_ln else x
            x = x + layer.mlp_forward(m_in, config.activation, dtype)
            if not pre_ln:
                x = layer.mlp_ln(x, eps)
            h[my] = x
    if model.final_ln is not None:
        h = [md.final_ln(x, eps) for md, x in zip(models, h)]
    return [x.float() for x in h]
