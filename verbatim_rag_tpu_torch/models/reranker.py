"""Cross-encoder reranking model (port of `verbatim_rag_tpu/models/reranker.py`).

(question, passage) pairs packed into one sequence → the encoder → the
``[CLS]`` state → tanh pooler → linear score. The "rerank only the top
``rerank_k``, keep the tail order" contract lives in
`verbatim_rag_tpu_torch.rag.rerankers`; this module is the model. With a
config whose ``use_flash_attention`` is set, the encoder runs the flash
forward kernel (head dim 32 at MiniLM width).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from verbatim_rag_tpu_torch.device import resolve_device

from .config import EncoderConfig, minilm_config
from .encoder import Dense, Encoder, cls_pool, compute_dtype
from .tokenizer import HashTokenizer, Tokenizer


class CrossEncoderModel(Encoder):
    """Encoder + ``pooler`` (dense, tanh) + one-unit ``score`` head."""

    def __init__(self, config: EncoderConfig, generator: torch.Generator | None = None):
        super().__init__(config, generator)
        h = config.hidden_size
        self.pooler = Dense(h, h, True, generator)
        self.score = Dense(h, 1, True, generator)


def init_cross_encoder_params(config: EncoderConfig, seed: int = 0, device=None) -> CrossEncoderModel:
    """The cross-encoder with the JAX package's random weights for ``seed``
    (``init_cross_encoder_params(jax.random.PRNGKey(seed))``, drawn in numpy
    by `models.jax_prng`), so a seed names the same model in both packages."""
    from .highlighter import params_from_jax
    from .jax_prng import init_cross_encoder_params as jax_init
    from .jax_prng import prng_key

    model = CrossEncoderModel(config)
    model.load_state_dict(params_from_jax(jax_init(prng_key(seed), config)))
    return model.to(resolve_device(device))


def cross_encoder_pooled(
    model: CrossEncoderModel,
    input_ids: torch.Tensor,  # [B, S] packed (query, passage) pairs
    attention_mask: torch.Tensor,
) -> torch.Tensor:
    """The tanh-pooled ``[CLS]`` state per pair — [B, H], the vector the
    score head reads."""
    hidden = model(input_ids, attention_mask)
    return torch.tanh(model.pooler(cls_pool(hidden), compute_dtype(model.config)))


def cross_encoder_scores(
    model: CrossEncoderModel,
    input_ids: torch.Tensor,  # [B, S] packed (query, passage) pairs
    attention_mask: torch.Tensor,
) -> torch.Tensor:
    """Relevance score per pair — [B] float32."""
    pooled = cross_encoder_pooled(model, input_ids, attention_mask)
    return model.score(pooled, compute_dtype(model.config))[:, 0]


class JaxCrossEncoder:
    """Host-facing wrapper: (question, texts) → scores.

    ``params`` is a state_dict for :class:`CrossEncoderModel` (for example
    from `highlighter.params_from_jax`); without it the weights are the JAX
    package's for ``seed``. The model lives on ``device`` (``None`` → ``cuda``).
    """

    def __init__(
        self,
        params: Mapping[str, torch.Tensor] | None = None,
        config: EncoderConfig | None = None,
        tokenizer: Tokenizer | None = None,
        max_length: int = 512,
        seed: int = 0,
        device=None,
    ):
        self.config = config or minilm_config()
        self.device = resolve_device(device)
        if params:
            self.model = CrossEncoderModel(self.config)
            self.model.load_state_dict(dict(params))
            self.model.to(self.device)
        else:
            self.model = init_cross_encoder_params(self.config, seed, self.device)
        self.model.eval()
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=self.config.vocab_size)
        self.max_length = max_length

    def _run(self, head, question: str, texts: list[str]) -> np.ndarray:
        enc = self.tokenizer.encode_batch(
            [question] * len(texts), pair=list(texts), max_length=self.max_length
        )
        with torch.inference_mode():
            out = head(
                self.model,
                torch.from_numpy(enc.input_ids).to(self.device),
                torch.from_numpy(enc.attention_mask).to(self.device),
            )
        return out.float().cpu().numpy()

    def score(self, question: str, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros(0, np.float32)
        return self._run(cross_encoder_scores, question, texts)

    def pooled(self, question: str, texts: list[str]) -> np.ndarray:
        """The pooled state the scores are read from — [len(texts), H]."""
        if not texts:
            return np.zeros((0, self.config.hidden_size), np.float32)
        return self._run(cross_encoder_pooled, question, texts)
