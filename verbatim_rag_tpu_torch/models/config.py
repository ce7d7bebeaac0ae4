"""Encoder architecture configs.

Copy of `verbatim_rag_tpu/models/config.py`: the config dataclass, the
presets (MiniLM and BERT-base for the dense and SPLADE providers,
ModernBERT-base and the compact demo highlighter for the extractor, and the
unit-test size) and the training knobs (`TrainingConfig`). One dataclass
covers both
families: BERT (absolute positions, post-LN, GELU, global attention) and
ModernBERT (RoPE, pre-LN, gated GeGLU, alternating local/global attention,
no biases, final LN).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.0  # inference-first; training sets >0

    # Architecture family switches.
    position_embedding_type: str = "absolute"  # "absolute" | "rope"
    norm_location: str = "post"  # "post" (BERT) | "pre" (ModernBERT)
    activation: str = "gelu"  # "gelu" | "geglu"
    use_bias: bool = True
    embedding_norm: bool = True  # LN after embeddings
    final_norm: bool = False  # LN after last layer (ModernBERT)

    # ModernBERT: layer 0 has no attention pre-norm (embeddings LN feeds it).
    first_layer_no_attn_norm: bool = False

    # RoPE / local attention (ModernBERT).
    global_rope_theta: float = 160_000.0
    local_rope_theta: float = 10_000.0
    local_attention_window: int = 128  # full window width
    global_attn_every_n_layers: int = 3  # layer i is global iff i % n == 0

    # Compute.
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # The JAX package's attention switch, kept so configs compare equal; the
    # port's encoder always runs `ops.flash_attention.flash_attention`.
    use_flash_attention: bool = False

    # Extra heads' dims (heads themselves configured at call sites).
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    def is_global_layer(self, layer_idx: int) -> bool:
        if self.position_embedding_type != "rope":
            return True
        return layer_idx % self.global_attn_every_n_layers == 0


def minilm_config(**overrides) -> EncoderConfig:
    """all-MiniLM-L6-v2-shaped config (384-d dense embedder)."""
    base = dict(
        compute_dtype="bfloat16",
        vocab_size=30522,
        hidden_size=384,
        num_layers=6,
        num_heads=12,
        intermediate_size=1536,
        max_position_embeddings=512,
    )
    base.update(overrides)
    return EncoderConfig(**base)


def bert_base_config(**overrides) -> EncoderConfig:
    """bert-base-uncased-shaped config (SPLADE backbones)."""
    base = dict(
        compute_dtype="bfloat16",
        vocab_size=30522,
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        max_position_embeddings=512,
    )
    base.update(overrides)
    return EncoderConfig(**base)


def modernbert_base_config(**overrides) -> EncoderConfig:
    """ModernBERT-base-shaped config (the 150M highlighter backbone)."""
    base = dict(
        use_flash_attention=True,
        compute_dtype="bfloat16",
        vocab_size=50368,
        hidden_size=768,
        num_layers=22,
        num_heads=12,
        intermediate_size=1152,  # gated: Wi emits 2×1152
        max_position_embeddings=8192,
        layer_norm_eps=1e-5,
        position_embedding_type="rope",
        norm_location="pre",
        activation="geglu",
        use_bias=False,
        final_norm=True,
        type_vocab_size=0,
        first_layer_no_attn_norm=True,
    )
    base.update(overrides)
    return EncoderConfig(**base)


def demo_highlighter_config(**overrides) -> EncoderConfig:
    """Compact ModernBERT-style config for checkpoint-free demos.

    Random weights carry no extraction quality, so the offline default
    doesn't pay for 150M parameters.
    """
    base = dict(
        vocab_size=30522,
        hidden_size=256,
        num_layers=4,
        num_heads=4,
        intermediate_size=512,
        max_position_embeddings=8192,
        layer_norm_eps=1e-5,
        position_embedding_type="rope",
        norm_location="pre",
        activation="geglu",
        use_bias=False,
        final_norm=True,
        type_vocab_size=0,
        first_layer_no_attn_norm=True,
        use_flash_attention=True,
    )
    base.update(overrides)
    return EncoderConfig(**base)


def tiny_test_config(**overrides) -> EncoderConfig:
    """Small config for unit tests (fast compile, real code paths)."""
    base = dict(
        vocab_size=128,
        hidden_size=32,
        num_layers=2,
        num_heads=4,
        intermediate_size=64,
        max_position_embeddings=64,
    )
    base.update(overrides)
    return EncoderConfig(**base)


@dataclass
class TrainingConfig:
    """Optimizer/schedule knobs for extractor training."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    warmup_steps: int = 0
    batch_size: int = 8
    num_epochs: int = 3
    max_seq_length: int = 4096
    seed: int = 42
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    extra: dict = field(default_factory=dict)
