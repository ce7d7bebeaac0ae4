"""SPLADE sparse encoder (port of `verbatim_rag_tpu/models/splade.py`).

encoder → MLM head (dense → GELU → LayerNorm → vocab projection tied to the
word embeddings, plus an output bias) → ``log(1 + relu(logit))`` → max over
sequence positions → a vocab-sized activation vector per text, of which only
the heaviest ``max_nnz`` terms are kept on the device.

:class:`SpladeModel` is an :class:`~.encoder.Encoder` with an ``mlm_head``,
so a JAX SPLADE tree converts with `highlighter.params_from_jax` as the
encoder's does (its keys are ``mlm_head.transform.*``, ``mlm_head.ln.*`` and
``mlm_head.output_bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from verbatim_rag_tpu_torch.device import resolve_device
from verbatim_rag_tpu_torch.ops.dense import matmul_f32, topk

from .config import EncoderConfig
from .encoder import Dense, Encoder, LayerNorm, compute_dtype

#: Sequence positions per vocab-logit chunk (the JAX scan's chunk).
SEQ_CHUNK = 32


class MlmHead(nn.Module):
    """Transform (dense + bias), LayerNorm and the output bias; the vocab
    projection itself is the encoder's word-embedding matrix."""

    def __init__(self, config: EncoderConfig, generator: torch.Generator | None = None):
        super().__init__()
        h = config.hidden_size
        self.transform = Dense(h, h, True, generator)
        self.ln = LayerNorm(h, True)
        self.output_bias = nn.Parameter(torch.zeros(config.vocab_size))


class SpladeModel(Encoder):
    """Encoder + MLM head."""

    def __init__(self, config: EncoderConfig, generator: torch.Generator | None = None):
        super().__init__(config, generator)
        self.mlm_head = MlmHead(config, generator)


def init_splade_params(config: EncoderConfig, seed: int = 0, device=None) -> SpladeModel:
    """Random-init the SPLADE model from an explicit ``torch.Generator`` seed
    (normal·0.02 kernels and embeddings, zero biases, unit LayerNorms)."""
    generator = torch.Generator().manual_seed(seed)
    return SpladeModel(config, generator).to(resolve_device(device))


def splade_forward(model: SpladeModel, input_ids, attention_mask) -> torch.Tensor:
    """Sparse activations [B, vocab] (float32, ≥ 0).

    The [B, S, V] logits are never materialised: log1p∘relu and max are
    monotone, so ``max_s log1p(relu(x_s)) = log1p(relu(max_s x_s))``, and the
    vocab projection runs as a running max over chunks of ``SEQ_CHUNK``
    positions (masked positions at −inf): O(chunk·V) memory per text. The
    projection is a plain product (bf16 operands, float32 result), as the
    JAX package leaves it to XLA.
    """
    config = model.config
    dtype = compute_dtype(config)
    hidden = model(input_ids, attention_mask)
    head = model.mlm_head
    x = head.transform(hidden, dtype)
    x = F.gelu(x.float(), approximate="none")
    x = head.ln(x, config.layer_norm_eps)  # [B, S, H] float32

    batch, seq, h = x.shape
    chunk = min(SEQ_CHUNK, seq)
    w_vocab = model.embeddings["word"].to(dtype).t()  # [H, V]
    live = attention_mask > 0
    vmax = torch.full(
        (batch, config.vocab_size), float("-inf"), dtype=torch.float32, device=x.device
    )
    for start in range(0, seq, chunk):
        x_c = x[:, start : start + chunk]
        n = x_c.shape[1]
        logits = matmul_f32(x_c.reshape(-1, h).to(dtype), w_vocab).reshape(batch, n, -1)
        logits = logits + head.output_bias
        logits = torch.where(live[:, start : start + n, None], logits, float("-inf"))
        vmax = torch.maximum(vmax, logits.amax(dim=1))
    return torch.log1p(torch.relu(vmax))


def splade_topk_terms(
    model: SpladeModel, input_ids, attention_mask, max_nnz: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse encode and keep only the heaviest ``max_nnz`` terms on device.

    Selection is exact with the lowest id first among equal weights
    (`ops.dense.topk`, ``lax.top_k``'s order).

    :return: (term ids int32 [B, max_nnz], weights float32 [B, max_nnz]);
        zero-weight slots are padding with id 0.
    """
    acts = splade_forward(model, input_ids, attention_mask)
    weights, ids = topk(acts, max_nnz)
    ids = torch.where(weights > 0, ids, 0)
    return ids.to(torch.int32), weights
