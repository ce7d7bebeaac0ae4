"""Encoder forward in the PyTorch port vs the JAX package.

One JAX parameter tree (random, from a JAX key) is converted with
`params_from_jax` and both forwards run on the same numpy token batch with
ragged lengths. Configs: `tiny_test_config` in its BERT form and in a
ModernBERT form (RoPE, pre-LN, GeGLU, local/global layers with a window
smaller than the sequence, flash attention on and off). float32; hidden
states at rtol/atol 5e-4, the tolerance of the JAX package's own HF-parity
tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.encoder import encoder_forward, init_encoder_params
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.encoder import Encoder
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax

MODERNBERT = dict(
    position_embedding_type="rope",
    norm_location="pre",
    activation="geglu",
    use_bias=False,
    final_norm=True,
    type_vocab_size=0,
    first_layer_no_attn_norm=True,
    layer_norm_eps=1e-5,
    num_layers=4,
    local_attention_window=8,
    global_attn_every_n_layers=2,
    max_position_embeddings=128,
)

CONFIGS = {
    "bert": {},
    "bert_flash": dict(use_flash_attention=True),
    "modernbert": MODERNBERT,
    "modernbert_flash": dict(MODERNBERT, use_flash_attention=True),
}


def _batch(vocab, lengths, seq, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(len(lengths), seq)).astype(np.int32)
    mask = (np.arange(seq)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


def _port_encoder(config_kwargs, seed=0):
    jax_config = jax_tiny_config(**config_kwargs)
    params = init_encoder_params(jax.random.PRNGKey(seed), jax_config)
    model = Encoder(tiny_test_config(**config_kwargs))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jax_config, params, model


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("lengths,seq", [([24, 17, 5], 24), ([40, 33], 40)])
def test_hidden_states_match_jax(name, lengths, seq):
    jax_config, params, model = _port_encoder(CONFIGS[name])
    ids, mask = _batch(jax_config.vocab_size, lengths, seq)
    expected = np.asarray(
        encoder_forward(params, jax_config, jnp.asarray(ids), jnp.asarray(mask))
    )
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=5e-4, atol=5e-4)


def test_state_dict_covers_every_parameter():
    _, params, model = _port_encoder(MODERNBERT)
    converted = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(converted) == set(model.state_dict())
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())


def test_modernbert_layer_schedule_matches_config():
    config = tiny_test_config(**MODERNBERT)
    assert [config.is_global_layer(i) for i in range(4)] == [True, False, True, False]
    assert len(Encoder(config).layers) == 4


@pytest.mark.parametrize("head_dim", [8, 32])
@pytest.mark.parametrize("family", ["bert", "modernbert"])
def test_flash_flag_off_runs_plain_attention_like_jax(monkeypatch, family, head_dim):
    """``use_flash_attention=False`` (the JAX default, and MiniLM's) runs the
    plain attention over the mask's additive bias, as JAX's
    `encoder_forward` does, at any head dim: the flash entry is never
    called. D = 8 is `tiny_test_config`'s (hidden 32, 4 heads), D = 32 the
    MiniLM-shaped one (hidden 64, 2 heads); rtol/atol 5e-4."""
    from verbatim_rag_tpu_torch.models import encoder as encoder_mod

    def refuse(*args, **kwargs):
        raise AssertionError("flash attention called with the flag off")

    monkeypatch.setattr(encoder_mod, "flash_attention", refuse)
    kwargs = dict(MODERNBERT if family == "modernbert" else {})
    if head_dim == 32:
        kwargs.update(hidden_size=64, num_heads=2, intermediate_size=64)
    jax_config, params, model = _port_encoder(kwargs, seed=head_dim)
    assert model.config.head_dim == head_dim and not model.config.use_flash_attention
    ids, mask = _batch(jax_config.vocab_size, [21, 9, 0, 16], 21, seed=head_dim)
    expected = np.asarray(encoder_forward(params, jax_config, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, expected, rtol=5e-4, atol=5e-4)
