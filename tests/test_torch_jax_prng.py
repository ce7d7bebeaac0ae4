"""The port's numpy copy of JAX's random initialisation vs `jax.random`.

A seed-only provider identity names the weights
``init_*_params(jax.random.PRNGKey(seed))``; `models/jax_prng.py` rebuilds
them without JAX. Tolerances: keys, splits, raw bits and uniforms
bit-equal; normals at rtol 1e-6 (XLA's float32 ``erf_inv`` takes its own
``log1p``: up to 3 ulp apart, 2.4e-7 relative, measured over 1M draws);
the initialisers' trees: the same leaves and shapes, values at rtol 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.models.config import minilm_config as jax_minilm
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny
from verbatim_rag_tpu.models.encoder import init_encoder_params as jax_init_encoder
from verbatim_rag_tpu.models.splade import init_splade_params as jax_init_splade
from verbatim_rag_tpu_torch.models import jax_prng, providers
from verbatim_rag_tpu_torch.models.config import minilm_config, tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax

NARROW = dict(hidden_size=64, num_heads=2, num_layers=3, intermediate_size=96, vocab_size=700,
              max_position_embeddings=80)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 123456, 2**31 - 1, -5, 2**32 + 1, 2**40 + 5, -(2**40) - 3])
def test_keys_and_splits_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    ours = jax_prng.prng_key(seed)
    np.testing.assert_array_equal(ours, np.asarray(jax.random.key_data(key)))
    for num in (1, 2, 6, 8, 13):
        np.testing.assert_array_equal(jax_prng.split(ours, num), np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (33, 5), (4, 3, 17), (1000, 384)])
def test_bits_and_uniforms_bit_equal(shape):
    key = jax.random.PRNGKey(11)
    ours = jax_prng.prng_key(11)
    np.testing.assert_array_equal(
        jax_prng.random_bits(ours, shape), np.asarray(jax.random.bits(key, shape, jnp.uint32))
    )
    np.testing.assert_array_equal(
        jax_prng.uniform(ours, shape, -1.0, 1.0),
        np.asarray(jax.random.uniform(key, shape, jnp.float32, -1.0, 1.0)),
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_normals_match(seed):
    key = jax.random.PRNGKey(seed)
    ours = jax_prng.normal(jax_prng.prng_key(seed), (1000, 1000))
    expected = np.asarray(jax.random.normal(key, (1000, 1000), jnp.float32))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, expected, rtol=1e-6, atol=0)


def test_erf_inv_edges():
    x = np.array([-1.0, 1.0, 0.0, -0.0, 0.5, np.nextafter(np.float32(-1), np.float32(0))], np.float32)
    got = jax_prng.erf_inv_f32(x)
    expected = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.isneginf(got[0]) and np.isposinf(got[1])
    np.testing.assert_allclose(got[2:], expected[2:], rtol=1e-6)


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize(
    "name", ["minilm_encoder", "minilm_splade", "tiny_encoder", "modernbert_encoder"]
)
def test_initialisers_match_jax(name):
    family, kind = name.split("_")
    if family == "minilm":
        ours_cfg, jax_cfg = minilm_config(**NARROW), jax_minilm(**NARROW)
    elif family == "tiny":
        ours_cfg, jax_cfg = tiny_test_config(), jax_tiny()
    else:
        extra = dict(position_embedding_type="rope", norm_location="pre", activation="geglu",
                      use_bias=False, final_norm=True, type_vocab_size=0)
        ours_cfg, jax_cfg = tiny_test_config(**extra), jax_tiny(**extra)
    ours_init = jax_prng.init_splade_params if kind == "splade" else jax_prng.init_encoder_params
    jax_init = jax_init_splade if kind == "splade" else jax_init_encoder
    ours = _leaves(ours_init(jax_prng.prng_key(9), ours_cfg))
    expected = _leaves(jax_init(jax.random.PRNGKey(9), jax_cfg))
    assert ours.keys() == expected.keys()
    for path, value in expected.items():
        value = np.asarray(value)
        assert ours[path].shape == value.shape and ours[path].dtype == np.float32, path
        np.testing.assert_allclose(ours[path], value, rtol=1e-6, atol=0, err_msg=str(path))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_seeded_providers_hold_the_jax_weights(kind):
    """A provider built from a seed (no params, no checkpoint) holds
    ``params_from_jax(init_*_params(PRNGKey(seed)))``."""
    cls = providers.JaxDenseProvider if kind == "dense" else providers.JaxSpladeProvider
    init = jax_init_encoder if kind == "dense" else jax_init_splade
    provider = cls(config=minilm_config(**NARROW), seed=4, device="cpu")
    expected = params_from_jax(jax.tree.map(np.asarray, init(jax.random.PRNGKey(4), jax_minilm(**NARROW))))
    state = provider.model.state_dict()
    assert state.keys() == expected.keys()
    for name, value in expected.items():
        torch.testing.assert_close(state[name], value, rtol=1e-6, atol=0)
