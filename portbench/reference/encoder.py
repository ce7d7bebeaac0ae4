"""Plain PyTorch forwards of the two encoder families the RAG cells serve,
written from their published descriptions, in float32 with TF32 off.

- ``bert`` (all-MiniLM-L6-v2): word + absolute position + token-type-0
  embeddings, LayerNorm, post-LN layers (attention, GELU MLP, biases).
- ``modernbert`` (ModernBERT-base): word embeddings, LayerNorm, pre-LN
  layers (none before layer 0's attention), rotary positions (half-split,
  theta 160,000 on global layers and 10,000 on local ones), attention over
  every key on each ``global_every``-th layer and over a band of ``window``
  keys on the others, gated GELU MLP, no biases, final LayerNorm.

Heads: the token classifier (two labels) and the SPLADE head (dense, GELU,
LayerNorm, the tied word embeddings and an output bias, then
``log(1 + relu)`` max-pooled over the row).

Each row runs alone at its own length, so padding never enters the
reference. ``precision="fp8"`` rounds every matmul operand and q, k and v
through float8 e4m3 with one scale a tensor: the control, one precision
below the bf16 operands the configuration serves.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def arch_of(group: dict) -> dict:
    """An encoder's sizes from a Hugging Face ``config.json`` group."""
    modern = group.get("model_type") == "modernbert"
    return dict(
        family="modernbert" if modern else "bert",
        vocab=group["vocab_size"],
        hidden=group["hidden_size"],
        layers=group["num_hidden_layers"],
        heads=group["num_attention_heads"],
        intermediate=group["intermediate_size"],
        max_positions=group["max_position_embeddings"],
        type_vocab=0 if modern else group["type_vocab_size"],
        eps=group["norm_eps"] if modern else group["layer_norm_eps"],
        global_theta=group.get("global_rope_theta", 0.0),
        local_theta=group.get("local_rope_theta", 0.0),
        window=group.get("local_attention", 0),
        global_every=group.get("global_attn_every_n_layers", 1),
    )


def param_spec(arch: dict, head: str) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter; init is ``normal`` (×0.02),
    ``ones`` or ``zeros``. ``head`` is ``classifier``, ``splade`` or
    ``none``."""
    h, v, i = arch["hidden"], arch["vocab"], arch["intermediate"]
    bert = arch["family"] == "bert"
    spec = [("embeddings.word", (v, h), "normal")]
    if bert:
        spec.append(("embeddings.position", (arch["max_positions"], h), "normal"))
    if arch["type_vocab"]:
        spec.append(("embeddings.token_type", (arch["type_vocab"], h), "normal"))

    def norm(name, bias):
        spec.append((f"{name}.scale", (h,), "ones"))
        if bias:
            spec.append((f"{name}.bias", (h,), "zeros"))

    def dense(name, d_in, d_out, bias):
        spec.append((f"{name}.kernel", (d_in, d_out), "normal"))
        if bias:
            spec.append((f"{name}.bias", (d_out,), "zeros"))

    norm("embeddings_ln", bert)
    wi = i if bert else 2 * i
    for layer in range(arch["layers"]):
        pre = f"layers.{layer}."
        for name in ("q", "k", "v", "o"):
            dense(f"{pre}attn.{name}", h, h, bert)
        norm(f"{pre}attn_ln", bert)
        dense(f"{pre}mlp.wi", h, wi, bert)
        dense(f"{pre}mlp.wo", i, h, bert)
        norm(f"{pre}mlp_ln", bert)
    if not bert:
        norm("final_ln", False)
    if head == "classifier":
        dense("classifier", h, 2, True)
    elif head == "splade":
        dense("mlm_head.transform", h, h, True)
        norm("mlm_head.ln", True)
        spec.append(("mlm_head.output_bias", (v,), "zeros"))
    return spec


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """One encoder with its parameters (a name → float32 tensor mapping)."""

    def __init__(self, arch: dict, params: dict, precision: str = "fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.arch = arch
        self.p = {k: v.float() for k, v in params.items()}
        self.round = _fp8 if precision == "fp8" else (lambda x: x)

    def _mm(self, x, name):
        out = self.round(x) @ self.round(self.p[f"{name}.kernel"])
        bias = self.p.get(f"{name}.bias")
        return out if bias is None else out + bias

    def _ln(self, x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + self.arch["eps"]) * self.p[f"{name}.scale"]
        bias = self.p.get(f"{name}.bias")
        return y if bias is None else y + bias

    def _rope(self, x, theta):
        n, _, d = x.shape
        half = d // 2
        inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) * 2.0 / d)
        ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v, band):
        """[n, H, D] each; ``band`` None (every key) or the half width."""
        n, heads, d = q.shape
        out = torch.empty_like(q)
        step = 1024
        for q0 in range(0, n, step):
            q1 = min(n, q0 + step)
            k0, k1 = (0, n) if band is None else (max(0, q0 - band), min(n, q1 + band))
            s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[k0:k1]) / math.sqrt(d)
            if band is not None:
                qi = torch.arange(q0, q1, device=q.device)[:, None]
                ki = torch.arange(k0, k1, device=q.device)[None, :]
                s = s.masked_fill((qi - ki).abs() > band, float("-inf"))
            out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[k0:k1])
        return out

    def hidden(self, ids: list[int]) -> torch.Tensor:
        """Final hidden states [n, hidden] of one row of live tokens."""
        a, p = self.arch, self.p
        dev = p["embeddings.word"].device
        idx = torch.tensor(ids, dtype=torch.long, device=dev)
        n, heads = len(ids), a["heads"]
        bert = a["family"] == "bert"
        x = p["embeddings.word"][idx]
        if bert:
            x = x + p["embeddings.position"][:n] + p["embeddings.token_type"][0]
        x = self._ln(x, "embeddings_ln")
        for layer in range(a["layers"]):
            pre = f"layers.{layer}."
            a_in = x if (bert or layer == 0) else self._ln(x, f"{pre}attn_ln")
            q, k, v = (self._mm(a_in, f"{pre}attn.{t}").reshape(n, heads, -1) for t in "qkv")
            band = None
            if not bert:
                is_global = layer % a["global_every"] == 0
                theta = a["global_theta"] if is_global else a["local_theta"]
                q, k = self._rope(q, theta), self._rope(k, theta)
                band = None if is_global else a["window"] // 2
            q, k, v = self.round(q), self.round(k), self.round(v)
            att = self._mm(self._attention(q, k, v, band).reshape(n, -1), f"{pre}attn.o")
            if bert:
                x = self._ln(x + att, f"{pre}attn_ln")
                m = self._mm(F.gelu(self._mm(x, f"{pre}mlp.wi")), f"{pre}mlp.wo")
                x = self._ln(x + m, f"{pre}mlp_ln")
            else:
                x = x + att
                gate, val = self._mm(self._ln(x, f"{pre}mlp_ln"), f"{pre}mlp.wi").chunk(2, dim=-1)
                x = x + self._mm(F.gelu(gate) * val, f"{pre}mlp.wo")
        return x if bert else self._ln(x, "final_ln")

    def token_probs(self, ids: list[int]) -> torch.Tensor:
        """P(label 1) of every token of the row."""
        logits = self._mm(self.hidden(ids), "classifier")
        return torch.softmax(logits, dim=-1)[:, 1]

    def dense_embedding(self, ids: list[int]) -> torch.Tensor:
        """Mean of the hidden states, L2-normalised."""
        pooled = self.hidden(ids).mean(0)
        return pooled / pooled.norm().clamp(min=1e-12)

    def splade_acts(self, ids: list[int]) -> torch.Tensor:
        """The row's activation of every vocabulary term."""
        x = self._ln(F.gelu(self._mm(self.hidden(ids), "mlm_head.transform")), "mlm_head.ln")
        logits = self.round(x) @ self.round(self.p["embeddings.word"]).t() + self.p["mlm_head.output_bias"]
        return torch.log1p(torch.relu(logits.amax(0)))

    def splade(self, ids: list[int], max_nnz: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The heaviest ``max_nnz`` terms (ids, weights; lowest id first among
        equal weights, zero weights dropped)."""
        acts = self.splade_acts(ids)
        top = torch.argsort(acts, descending=True, stable=True)[:max_nnz]
        w = acts[top]
        return top[w > 0], w[w > 0]
