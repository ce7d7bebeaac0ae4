"""PyTorch models: encoder stack and the span-extraction highlighter."""

from .config import (
    EncoderConfig,
    demo_highlighter_config,
    modernbert_base_config,
    tiny_test_config,
)
from .encoder import Encoder, encoder_forward_sp
from .highlighter import (
    HighlighterModel,
    ModelSpanExtractor,
    init_highlighter_params,
    params_from_jax,
    params_to_jax,
    select_spans_from_token_probs,
    token_relevance_probs,
    token_relevance_probs_sp,
)
from .tokenizer import HashTokenizer, TokenizedBatch

__all__ = [
    "Encoder",
    "EncoderConfig",
    "HashTokenizer",
    "HighlighterModel",
    "ModelSpanExtractor",
    "TokenizedBatch",
    "demo_highlighter_config",
    "encoder_forward_sp",
    "init_highlighter_params",
    "modernbert_base_config",
    "params_from_jax",
    "params_to_jax",
    "select_spans_from_token_probs",
    "tiny_test_config",
    "token_relevance_probs",
    "token_relevance_probs_sp",
]
