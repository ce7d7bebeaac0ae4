"""Sequence-parallel encoder and extractor in the PyTorch port vs the JAX package.

The JAX side runs on its 8 virtual CPU devices, the port on a mesh of 8
repeated ``"cpu"`` devices; one JAX parameter tree goes to both
(`params_from_jax`). Tolerances: hidden states and token probabilities
(float32) rtol/atol 5e-4, spans equal. The span threshold sits in a wide gap
of the JAX probabilities, so no span can hinge on a probability within the
tolerance of it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.encoder import (
    encoder_forward as jax_forward,
    encoder_forward_sp as jax_forward_sp,
    init_encoder_params as jax_init_encoder,
)
from verbatim_rag_tpu.models.highlighter import (
    ModelSpanExtractor as JaxExtractor,
    init_highlighter_params as jax_init_highlighter,
    token_relevance_probs_sp as jax_probs_sp,
)
from verbatim_rag_tpu.models.tokenizer import HashTokenizer as JaxTokenizer
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu_torch.models import (
    Encoder,
    HighlighterModel,
    ModelSpanExtractor,
    encoder_forward_sp,
    params_from_jax,
    token_relevance_probs_sp,
)
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
from verbatim_rag_tpu_torch.ops.ring_attention import shard_sequence
from verbatim_rag_tpu_torch.parallel import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

MODERNBERT = dict(
    position_embedding_type="rope",
    norm_location="pre",
    activation="geglu",
    use_bias=False,
    final_norm=True,
    type_vocab_size=0,
    first_layer_no_attn_norm=True,
    global_attn_every_n_layers=2,
    local_attention_window=16,  # halo 8 ≤ shard_len 8
    num_layers=4,
)
#: The two configs of the JAX package's SP tests: BERT-style (every layer
#: global: ring only) and ModernBERT-style (ring + halo).
CONFIGS = {"bert": dict(type_vocab_size=0), "modernbert": MODERNBERT}


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(dp=1, tp=8), make_mesh(dp=1, tp=8, devices=["cpu"] * 8)


def _rows(vocab, length_two):
    rng = np.random.default_rng(13)
    ids = rng.integers(3, vocab, size=(2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[1, length_two:] = 0
    ids[1, length_two:] = 0
    return ids, mask


def _jax_sharded(mesh, *arrays):
    shard = NamedSharding(mesh, P(None, "tp"))
    return [jax.device_put(jnp.asarray(x), shard) for x in arrays]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_forward_sp_matches_jax(meshes, name):
    jax_mesh, mesh = meshes
    overrides = CONFIGS[name]
    jax_config = jax_tiny_config(**overrides)
    params = jax_init_encoder(jax.random.PRNGKey(1), jax_config)
    model = Encoder(tiny_test_config(**overrides))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ids, mask = _rows(jax_config.vocab_size, 40)

    expected_sp = np.asarray(jax_forward_sp(params, jax_config, *_jax_sharded(jax_mesh, ids, mask), jax_mesh))
    expected = np.asarray(jax_forward(params, jax_config, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        shards = encoder_forward_sp(
            model,
            shard_sequence(torch.from_numpy(ids), mesh),
            shard_sequence(torch.from_numpy(mask), mesh),
            mesh,
        )
        single = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert len(shards) == 8 and all(s.shape == (2, 8, jax_config.hidden_size) for s in shards)
    got = torch.cat(shards, dim=1).numpy()
    np.testing.assert_allclose(got, expected_sp, rtol=5e-4, atol=5e-4)
    for ref in (expected, single):  # the single-device forward, on live tokens
        np.testing.assert_allclose(got[0], ref[0], rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(got[1, :40], ref[1, :40], rtol=5e-4, atol=5e-4)


EXTRACTOR = dict(MODERNBERT, num_layers=2, max_position_embeddings=1024)


@pytest.fixture(scope="module")
def highlighter():
    params = jax_init_highlighter(jax.random.PRNGKey(5), jax_tiny_config(**EXTRACTOR))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def test_token_probs_sp_match_jax(meshes, highlighter):
    jax_mesh, mesh = meshes
    params, state = highlighter
    ids, mask = _rows(128, 23)
    expected = np.asarray(
        jax_probs_sp(params, jax_tiny_config(**EXTRACTOR), *_jax_sharded(jax_mesh, ids, mask), jax_mesh)
    )
    model = HighlighterModel(tiny_test_config(**EXTRACTOR))
    model.load_state_dict(state)
    with torch.no_grad():
        shards = token_relevance_probs_sp(
            model,
            shard_sequence(torch.from_numpy(ids), mesh),
            shard_sequence(torch.from_numpy(mask), mesh),
            mesh,
        )
    got = np.concatenate([s.numpy() for s in shards], axis=1)
    np.testing.assert_allclose(got, expected, rtol=5e-4, atol=5e-4)
    assert (got[mask == 0] == 0).all()


def _threshold_in_gap(extractor, question, context):
    """A threshold in the widest gap of the JAX probabilities (middle half)."""
    probs = []
    original = extractor._forward_probs

    def spy(ids, mask):
        out = original(ids, mask)
        probs.append(out[mask.astype(bool)])
        return out

    extractor._forward_probs = spy
    extractor.process(question, context)
    extractor._forward_probs = original
    values = np.sort(np.concatenate(probs))
    lo, hi = len(values) // 4, 3 * len(values) // 4
    gaps = np.diff(values[lo:hi])
    i = int(np.argmax(gaps))
    assert gaps[i] > 2e-3
    return float((values[lo + i] + values[lo + i + 1]) / 2)


def test_sp_extractor_spans_match_jax_and_windowed(meshes, highlighter):
    """One sharded pass: the port's spans equal the JAX SP extractor's and
    the port's own windowed path's (its max_length holds the whole row, so
    both paths see the same token layout)."""
    jax_mesh, mesh = meshes
    params, state = highlighter
    context = " ".join(f"word{i} noteworthy item{i}." for i in range(40))
    question = "what is noteworthy?"
    common = dict(max_length=512, doc_stride=16, min_span_chars=10, merge_gap_chars=5)
    jax_sp = JaxExtractor(
        params=params, config=jax_tiny_config(**EXTRACTOR),
        tokenizer=JaxTokenizer(vocab_size=128), sp_mesh=jax_mesh, **common,
    )
    jax_sp.threshold = _threshold_in_gap(jax_sp, question, context)
    port = dict(
        params=state, config=tiny_test_config(**EXTRACTOR), tokenizer=HashTokenizer(vocab_size=128),
        threshold=jax_sp.threshold, device="cpu", **common,
    )
    port_sp = ModelSpanExtractor(sp_mesh=mesh, **port)
    windowed = ModelSpanExtractor(**port)
    expected = jax_sp.process(question, context)
    got = port_sp.process(question, context)
    assert got == expected and got
    assert windowed.process(question, context) == got
    assert len(port_sp._plan(question, context)["rows"]) == 1


def test_sp_extractor_scores_past_max_length_in_one_window(meshes, highlighter):
    """With a mesh the row is one window of the whole context, not capped at
    max_length: a context far beyond max_length is one row, scored whole."""
    _, mesh = meshes
    _, state = highlighter
    context = " ".join(f"word{i} noteworthy item{i}." for i in range(60))
    extractor = ModelSpanExtractor(
        params=state, config=tiny_test_config(**EXTRACTOR), max_length=64, doc_stride=16,
        sp_mesh=mesh, device="cpu", threshold=0.0, min_span_chars=1,
    )
    seen = []
    original = extractor._forward_probs

    def spy(ids, mask):
        seen.append(ids.shape)
        return original(ids, mask)

    extractor._forward_probs = spy
    spans = extractor.process("what is noteworthy?", context)
    assert seen == [(1, 256)]
    assert spans == [(0, len(context))]


def test_sp_long_row_is_not_truncated_in_layout(meshes):
    """SP rows past the last tokenizer bucket are multiples of 8192, not
    clamped to it: the aggregation layout sees the whole context. The
    forward is stubbed: this exercises the window/layout/aggregation
    plumbing only (the JAX package's test of the same name)."""
    _, mesh = meshes

    class StubForward(ModelSpanExtractor):
        def _forward_probs(self, ids, mask):
            return np.ones(ids.shape, np.float32) * mask

    extractor = StubForward(
        config=tiny_test_config(), threshold=0.5, min_span_chars=3, merge_gap_chars=5,
        sp_mesh=mesh, device="cpu",
    )
    context = "word " * 9000 + "needle."
    spans = extractor.process("find the needle", context)
    assert spans and spans[-1][1] == len(context)
