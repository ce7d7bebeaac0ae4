"""PyTorch models: encoder stack, the span-extraction highlighters, SPLADE,
the cross-encoder and the neural embedding providers."""

from .config import (
    EncoderConfig,
    TrainingConfig,
    bert_base_config,
    demo_highlighter_config,
    minilm_config,
    modernbert_base_config,
    tiny_test_config,
)
from .encoder import Encoder, cls_pool, embed_texts, encoder_forward_sp, mean_pool
from .highlighter import (
    HighlighterModel,
    ModelSpanExtractor,
    SemanticHighlightExtractor,
    init_highlighter_params,
    params_from_jax,
    params_to_jax,
    select_spans_from_token_probs,
    token_relevance_probs,
    token_relevance_probs_sp,
)
from .jax_prng import init_encoder_params
from .providers import JaxDenseProvider, JaxSpladeProvider, provider_from_config
from .reranker import (
    CrossEncoderModel,
    JaxCrossEncoder,
    cross_encoder_pooled,
    cross_encoder_scores,
    init_cross_encoder_params,
)
from .splade import SpladeModel, init_splade_params, splade_forward, splade_topk_terms
from .tokenizer import HashTokenizer, HFTokenizer, TokenizedBatch

__all__ = [
    "CrossEncoderModel",
    "Encoder",
    "EncoderConfig",
    "HFTokenizer",
    "HashTokenizer",
    "HighlighterModel",
    "JaxCrossEncoder",
    "JaxDenseProvider",
    "JaxSpladeProvider",
    "ModelSpanExtractor",
    "SemanticHighlightExtractor",
    "SpladeModel",
    "TokenizedBatch",
    "TrainingConfig",
    "bert_base_config",
    "cls_pool",
    "cross_encoder_pooled",
    "cross_encoder_scores",
    "demo_highlighter_config",
    "embed_texts",
    "encoder_forward_sp",
    "init_cross_encoder_params",
    "init_encoder_params",
    "init_highlighter_params",
    "init_splade_params",
    "mean_pool",
    "minilm_config",
    "modernbert_base_config",
    "params_from_jax",
    "params_to_jax",
    "provider_from_config",
    "select_spans_from_token_probs",
    "splade_forward",
    "splade_topk_terms",
    "tiny_test_config",
    "token_relevance_probs",
    "token_relevance_probs_sp",
]
