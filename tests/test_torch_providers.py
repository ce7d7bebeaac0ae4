"""The neural embedding providers of the PyTorch port vs the JAX package.

One JAX parameter tree per model (random, from a JAX key) is carried into the
port with `params_from_jax`; both sides run on the same numpy token batches
or the same texts. Configs: `tiny_test_config` in its BERT form and a narrow
MiniLM shape (two heads of 32, MiniLM's head dim), float32 compute.
Tolerances: float32 forwards (`embed_texts` with and without its L2
normalisation, `cls_pool`, `splade_forward`, the providers' embeddings and
term weights) rtol/atol 5e-4, the tolerance of the
encoder's parity tests; selected term ids equal. The providers run on
``device="cpu"`` (the kernels' plain versions); ``device=None`` means the
GPU and raises without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.models import providers as jax_providers
from verbatim_rag_tpu.models.config import minilm_config as jax_minilm_config
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.encoder import cls_pool as jax_cls_pool
from verbatim_rag_tpu.models.encoder import embed_texts as jax_embed_texts
from verbatim_rag_tpu.models.encoder import encoder_forward, init_encoder_params
from verbatim_rag_tpu.models.encoder import mean_pool as jax_mean_pool
from verbatim_rag_tpu.models.splade import init_splade_params as jax_init_splade
from verbatim_rag_tpu.models.splade import splade_forward as jax_splade_forward
from verbatim_rag_tpu.models.splade import splade_topk_terms as jax_splade_topk_terms
from verbatim_rag_tpu_torch.models import providers
from verbatim_rag_tpu_torch.models.config import minilm_config, tiny_test_config
from verbatim_rag_tpu_torch.models.encoder import Encoder, cls_pool, embed_texts
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax
from verbatim_rag_tpu_torch.models.splade import (
    SpladeModel,
    init_splade_params,
    splade_forward,
    splade_topk_terms,
)

TOL = dict(rtol=5e-4, atol=5e-4)
NARROW_MINILM = dict(
    hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128, vocab_size=512,
    max_position_embeddings=128, compute_dtype="float32",
)
CONFIGS = {
    "bert_tiny": (tiny_test_config, jax_tiny_config, {}),
    "minilm_narrow": (minilm_config, jax_minilm_config, NARROW_MINILM),
}
TEXTS = [
    "Solar panels convert sunlight into electricity.",
    "",
    "Wind",
    " ".join(["Offshore wind farms see steadier and stronger winds than onshore sites."] * 4),
    "How is energy stored for the night? Batteries, pumped hydro and molten salt.",
    "a b c d e f g h i j k l m n o p",
    "Grid operators balance supply and demand every second of the day.",
    "Photovoltaic efficiency: 15-22 percent for common modules.",
]


def _configs(name):
    ours, theirs, overrides = CONFIGS[name]
    return ours(**overrides), theirs(**overrides)


def _to_state(params) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, params))


def _batch(vocab, lengths, seq, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(len(lengths), seq)).astype(np.int32)
    mask = (np.arange(seq)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    """(name, port config, JAX config, dense JAX params, SPLADE JAX params,
    port Encoder, port SpladeModel) with one set of weights per model."""
    cfg, jax_cfg = _configs(request.param)
    dense_params = init_encoder_params(jax.random.PRNGKey(1), jax_cfg)
    splade_params = jax_init_splade(jax.random.PRNGKey(2), jax_cfg)
    encoder = Encoder(cfg)
    encoder.load_state_dict(_to_state(dense_params))
    splade = SpladeModel(cfg)
    splade.load_state_dict(_to_state(splade_params))
    return request.param, cfg, jax_cfg, dense_params, splade_params, encoder.eval(), splade.eval()


def test_splade_state_dict_covers_every_parameter(models):
    _, cfg, _, _, splade_params, _, splade = models
    converted = _to_state(splade_params)
    assert set(converted) == set(splade.state_dict())
    assert {k for k in converted if k.startswith("mlm_head.")} == {
        "mlm_head.transform.kernel", "mlm_head.transform.bias", "mlm_head.ln.scale",
        "mlm_head.ln.bias", "mlm_head.output_bias",
    }
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(splade_params))
    assert n_jax == sum(p.numel() for p in splade.parameters())
    fresh = init_splade_params(cfg, seed=0, device="cpu")
    assert set(fresh.state_dict()) == set(converted)


@pytest.mark.parametrize("lengths,seq", [([24, 17, 5, 1], 24), ([40, 33, 0], 40)])
def test_embed_texts_matches_jax(models, lengths, seq):
    _, _, jax_cfg, dense_params, _, encoder, _ = models
    ids, mask = _batch(jax_cfg.vocab_size, lengths, seq)
    expected = np.asarray(jax_embed_texts(dense_params, jax_cfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        got = embed_texts(encoder, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        raw = embed_texts(encoder, torch.from_numpy(ids), torch.from_numpy(mask), normalize=False)
        hidden = encoder(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == np.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got, expected, **TOL)
    jax_hidden = encoder_forward(dense_params, jax_cfg, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(
        raw.numpy(), np.asarray(jax_mean_pool(jax_hidden, jnp.asarray(mask))), **TOL
    )
    np.testing.assert_allclose(cls_pool(hidden).numpy(), np.asarray(jax_cls_pool(jax_hidden)), **TOL)


@pytest.mark.parametrize("lengths,seq", [([24, 17, 5, 1], 24), ([40, 33, 0], 40), ([64, 9], 64)])
def test_splade_forward_matches_jax(models, lengths, seq):
    """Sequences of one, two and three 32-position chunks (40: a ragged last
    chunk), a zero-length row (all −inf, so 0 after log1p∘relu)."""
    _, _, jax_cfg, _, splade_params, _, splade = models
    ids, mask = _batch(jax_cfg.vocab_size, lengths, seq, seed=seq)
    expected = np.asarray(jax_splade_forward(splade_params, jax_cfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        got = splade_forward(splade, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (len(lengths), jax_cfg.vocab_size) and (got >= 0).all()
    np.testing.assert_allclose(got, expected, **TOL)


@pytest.mark.parametrize("max_nnz", [8, 64])
def test_splade_topk_terms_match_jax(models, max_nnz):
    _, _, jax_cfg, _, splade_params, _, splade = models
    ids, mask = _batch(jax_cfg.vocab_size, [30, 12, 3, 0], 30, seed=max_nnz)
    e_ids, e_w = jax_splade_topk_terms(
        splade_params, jax_cfg, jnp.asarray(ids), jnp.asarray(mask), max_nnz=max_nnz
    )
    with torch.inference_mode():
        g_ids, g_w = splade_topk_terms(splade, torch.from_numpy(ids), torch.from_numpy(mask), max_nnz)
    assert g_ids.dtype == torch.int32 and g_w.dtype == torch.float32
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(e_ids))
    np.testing.assert_allclose(g_w.numpy(), np.asarray(e_w), **TOL)
    assert (g_ids.numpy()[g_w.numpy() <= 0] == 0).all()


def _provider_pair(models, kind, batch_size, **kwargs):
    name, cfg, jax_cfg, dense_params, splade_params, encoder, splade = models
    max_length = 64 if name == "bert_tiny" else 128
    if kind == "dense":
        theirs = jax_providers.JaxDenseProvider(
            params=dense_params, config=jax_cfg, max_length=max_length, batch_size=batch_size, **kwargs
        )
        ours = providers.JaxDenseProvider(
            params=encoder.state_dict(), config=cfg, max_length=max_length, batch_size=batch_size,
            device="cpu", **kwargs,
        )
    else:
        theirs = jax_providers.JaxSpladeProvider(
            params=splade_params, config=jax_cfg, max_length=max_length, batch_size=batch_size, **kwargs
        )
        ours = providers.JaxSpladeProvider(
            params=splade.state_dict(), config=cfg, max_length=max_length, batch_size=batch_size,
            device="cpu", **kwargs,
        )
    return ours, theirs


@pytest.mark.parametrize("batch_size", [3, 16])
def test_dense_provider_matches_jax(models, batch_size):
    """Batches of 3 over 8 texts of mixed lengths: three length-sorted chunks,
    the last padded with empty texts; caller order restored on the host
    (`embed_batch`) and on the device (`embed_batch_device`)."""
    ours, theirs = _provider_pair(models, "dense", batch_size)
    expected = theirs.embed_batch(TEXTS)
    got = ours.embed_batch(TEXTS)
    assert got.shape == (len(TEXTS), ours.get_dimension()) and got.dtype == np.float32
    np.testing.assert_allclose(got, expected, **TOL)
    on_device = ours.embed_batch_device(TEXTS)
    assert isinstance(on_device, torch.Tensor) and not on_device.is_inference()
    np.testing.assert_array_equal(on_device.numpy(), got)
    np.testing.assert_allclose(on_device.numpy(), np.asarray(theirs.embed_batch_device(TEXTS)), **TOL)
    np.testing.assert_allclose(ours.embed_text(TEXTS[4]), expected[4], **TOL)
    assert ours.embed_batch([]).shape == (0, ours.get_dimension())


@pytest.mark.parametrize("batch_size", [3, 16])
def test_splade_provider_matches_jax(models, batch_size):
    ours, theirs = _provider_pair(models, "sparse", batch_size, max_nnz=16)
    e_ids, e_w = theirs.embed_batch_arrays(TEXTS)
    g_ids, g_w = ours.embed_batch_arrays(TEXTS)
    assert g_ids.dtype == np.int32 and g_w.dtype == np.float32 and g_ids.shape == (len(TEXTS), 16)
    np.testing.assert_array_equal(g_ids, e_ids)
    np.testing.assert_allclose(g_w, e_w, **TOL)
    d_ids, d_w = ours.embed_query_arrays_device(TEXTS)
    j_ids, j_w = theirs.embed_query_arrays_device(TEXTS)
    np.testing.assert_array_equal(d_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(d_w.numpy(), np.asarray(j_w), **TOL)
    np.testing.assert_array_equal(d_ids.numpy(), g_ids)
    np.testing.assert_array_equal(d_w.numpy(), g_w)
    dicts, jax_dicts = ours.embed_batch(TEXTS), theirs.embed_batch(TEXTS)
    assert [sorted(d) for d in dicts] == [sorted(d) for d in jax_dicts]
    for d, e in zip(dicts, jax_dicts):
        np.testing.assert_allclose([d[t] for t in sorted(d)], [e[t] for t in sorted(e)], **TOL)


def test_dispatch_chunks_order_matches_jax():
    """Same length-sorted chunks, the same ``perm`` and a last chunk padded
    to the full batch with empty texts, on both sides."""
    tokenizer = providers.HashTokenizer(vocab_size=128)
    seen = []

    def torch_forward(ids, mask):
        seen.append(ids.shape[0])
        return ids[:, :1]

    ours = providers._dispatch_chunks(list(TEXTS), 3, tokenizer, 64, torch_forward, "cpu")
    theirs = jax_providers._dispatch_chunks(list(TEXTS), 3, tokenizer, 64, lambda i, m: i[:, :1])
    assert ours[1] == theirs[1] and len(ours[1]) == 3
    np.testing.assert_array_equal(ours[2], theirs[2])
    assert seen == [3, 3, 3]
    for got, expected in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def test_describe_equals_jax_and_round_trips(models):
    name, cfg, jax_cfg, *_ = models
    for kind in ("dense", "sparse"):
        extra = {"max_nnz": 16} if kind == "sparse" else {}
        ours, theirs = _provider_pair(models, kind, 4, seed=7, **extra)
        assert ours.describe() == theirs.describe()
        assert ours.describe()["reconstructible"] is False
        with pytest.raises(ValueError, match="cannot be reconstructed"):
            providers.provider_from_config(ours.describe(), device="cpu")
    cls = {"dense": providers.JaxDenseProvider, "sparse": providers.JaxSpladeProvider}
    jax_cls = {"dense": jax_providers.JaxDenseProvider, "sparse": jax_providers.JaxSpladeProvider}
    for kind in ("dense", "sparse"):
        ours = cls[kind](config=cfg, max_length=48, batch_size=5, seed=3, device="cpu")
        theirs = jax_cls[kind](config=jax_cfg, max_length=48, batch_size=5, seed=3)
        assert ours.describe() == theirs.describe() and ours.describe()["reconstructible"]
        rebuilt = providers.provider_from_config(theirs.describe(), device="cpu")
        assert type(rebuilt) is cls[kind] and rebuilt.describe() == theirs.describe()
        # The seed-only identity names the JAX package's weights: the rebuilt
        # provider embeds within 5e-4 of the JAX provider.
        if kind == "dense":
            np.testing.assert_allclose(
                rebuilt.embed_batch(list(TEXTS)), theirs.embed_batch(list(TEXTS)), atol=5e-4
            )
        else:
            got, expected = rebuilt.embed_batch(list(TEXTS)), theirs.embed_batch(list(TEXTS))
            for g, e in zip(got, expected):
                assert g.keys() == e.keys()
                np.testing.assert_allclose(
                    [g[t] for t in e], [e[t] for t in e], atol=5e-4
                )
        same = providers.provider_from_config(ours.describe(), device="cpu")
        for a, b in zip(same.model.state_dict().values(), ours.model.state_dict().values()):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Unknown JAX provider class"):
        providers.provider_from_config({"class": "Nope"}, device="cpu")


def test_checkpoint_loads_the_jax_weights(models, tmp_path):
    """A trainer-layout ``params.npz`` (the JAX `Trainer.save_checkpoint`
    keys) loads into the port's provider: embeddings equal JAX's provider
    built from the same checkpoint."""
    _, cfg, jax_cfg, dense_params, *_ = models
    flat, _ = jax.tree_util.tree_flatten_with_path(dense_params)
    arrays = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
        for path, leaf in flat
    }
    np.savez(tmp_path / "params.npz", **arrays)
    ours = providers.JaxDenseProvider(config=cfg, max_length=64, checkpoint=str(tmp_path), device="cpu")
    theirs = jax_providers.JaxDenseProvider(config=jax_cfg, max_length=64, checkpoint=str(tmp_path))
    np.testing.assert_allclose(ours.embed_batch(TEXTS[:3]), theirs.embed_batch(TEXTS[:3]), **TOL)
    assert ours.describe() == theirs.describe() and ours.describe()["reconstructible"]


def test_default_device_is_the_gpu(monkeypatch):
    """``device=None`` means CUDA: without a GPU the providers raise instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    for cls in (providers.JaxDenseProvider, providers.JaxSpladeProvider):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(config=cfg)
        assert cls(config=cfg, device="cpu").device.type == "cpu"
