"""Span extractor in the PyTorch port vs the JAX package.

Both extractors get one JAX parameter tree (the port through
`params_from_jax`) and a tiny ModernBERT-style config. Token probabilities
are compared at rtol/atol 5e-4; char spans must be equal, on the
single-window path, the multi-window path (max_length far below the
document), and the >512-row path (bursts scored in 512-row slices). The
span threshold is placed in a wide gap of the JAX probabilities, so the
comparison of spans cannot hinge on a probability within the tolerance of
the threshold.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.highlighter import (
    ModelSpanExtractor as JaxExtractor,
    init_highlighter_params as jax_init,
    token_relevance_probs as jax_probs,
)
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import (
    HighlighterModel,
    ModelSpanExtractor,
    params_from_jax,
    token_relevance_probs,
)

OVERRIDES = dict(
    vocab_size=512,
    hidden_size=32,
    num_heads=2,
    num_layers=3,
    intermediate_size=32,
    max_position_embeddings=4096,
    position_embedding_type="rope",
    norm_location="pre",
    activation="geglu",
    use_bias=False,
    final_norm=True,
    type_vocab_size=0,
    first_layer_no_attn_norm=True,
    layer_norm_eps=1e-5,
    local_attention_window=16,
    use_flash_attention=True,
)

WORDS = (
    "solar panels convert sunlight into electricity using photovoltaic cells while "
    "wind turbines harvest kinetic energy and batteries store the surplus for night "
    "grids balance supply against demand with markets reserves and careful planning"
).split()


def _doc(n_words, seed):
    rng = np.random.default_rng(seed)
    words = rng.choice(WORDS, size=n_words)
    return ". ".join(" ".join(words[i : i + 9]) for i in range(0, n_words, 9)) + "."


@pytest.fixture(scope="module")
def jax_params():
    params = jax_init(jax.random.PRNGKey(7), jax_tiny_config(**OVERRIDES))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def test_token_probs_match_jax(jax_params):
    params, state = jax_params
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 512, size=(3, 64)).astype(np.int32)
    mask = (np.arange(64)[None, :] < np.array([[64], [41], [9]])).astype(np.int32)
    expected = np.asarray(
        jax_probs(params, jax_tiny_config(**OVERRIDES), jnp.asarray(ids), jnp.asarray(mask))
    )
    model = HighlighterModel(tiny_test_config(**OVERRIDES))
    model.load_state_dict(state)
    with torch.no_grad():
        got = token_relevance_probs(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, expected, rtol=5e-4, atol=5e-4)
    assert (got[mask == 0] == 0).all()
    # The extractor's forward on the live tokens alone, flash on and off, on
    # weights spread so that attention and RoPE move the probabilities.
    spread = _spread(params)
    expected = np.asarray(jax_probs(spread, jax_tiny_config(**OVERRIDES), jnp.asarray(ids), jnp.asarray(mask)))
    assert np.ptp(expected[mask == 1]) > 0.3
    for flash in (True, False):
        config = tiny_test_config(**dict(OVERRIDES, use_flash_attention=flash))
        extractor = ModelSpanExtractor(params=params_from_jax(jax.tree.map(np.asarray, spread)), config=config, device="cpu")
        packed = extractor._forward_probs(ids, mask)
        np.testing.assert_allclose(packed, expected * mask, rtol=5e-4, atol=5e-4, err_msg=f"flash={flash}")
        assert (packed[mask == 0] == 0).all()


def _spread(params, std: float = 0.3, seed: int = 5):
    """JAX ``params`` redrawn at ``std`` about their init means (norm scales
    about 1), so that the probabilities spread over (0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        mean = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
        return jnp.asarray(rng.normal(mean, std, size=leaf.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, params)


def _threshold_in_gap(extractor, question, contexts):
    """A threshold in the widest gap of the JAX probabilities (middle half)."""
    probs = []
    original = extractor._forward_probs

    def spy(ids, mask):
        out = original(ids, mask)
        probs.append(out[mask.astype(bool)])
        return out

    extractor._forward_probs = spy
    extractor.process_batch(question, contexts)
    extractor._forward_probs = original
    values = np.sort(np.concatenate(probs))
    lo, hi = len(values) // 4, 3 * len(values) // 4
    gaps = np.diff(values[lo:hi])
    i = int(np.argmax(gaps))
    assert gaps[i] > 2e-3
    return float((values[lo + i] + values[lo + i + 1]) / 2)


CASES = {
    # name: (n_docs, words per doc, max_length, doc_stride)
    "single_window": (3, 60, 8192, 256),
    "multi_window": (2, 400, 96, 24),
    "over_512_rows": (520, 12, 8192, 256),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_match_jax(jax_params, case):
    params, state = jax_params
    n_docs, n_words, max_length, stride = CASES[case]
    contexts = [_doc(n_words, seed) for seed in range(n_docs)]
    question = "how do solar panels store energy for the grid at night"
    kwargs = dict(max_length=max_length, doc_stride=stride, min_span_chars=10)
    jax_ex = JaxExtractor(params=params, config=jax_tiny_config(**OVERRIDES), **kwargs)
    threshold = _threshold_in_gap(jax_ex, question, contexts[:8])
    jax_ex.threshold = threshold
    port_ex = ModelSpanExtractor(
        params=state, config=tiny_test_config(**OVERRIDES), threshold=threshold,
        device="cpu", **kwargs,
    )
    expected = jax_ex.process_batch(question, contexts)
    got = port_ex.process_batch(question, contexts)
    assert got == expected
    assert any(spans for spans in got)
    if case == "multi_window":
        assert len(port_ex._plan(question, contexts[0])["rows"]) > 1


def test_slices_bound_tokens_and_match_jax(jax_params, monkeypatch):
    """A burst is scored in slices of at most SLICE_TOKENS tokens (here a
    few rows each, where the JAX package takes 512 rows a slice), and the
    spans stay those of the JAX extractor."""
    from verbatim_rag_tpu_torch.models import highlighter

    params, state = jax_params
    contexts = [_doc(12 + 3 * seed, seed) for seed in range(40)]
    question = "how do solar panels store energy for the grid at night"
    kwargs = dict(max_length=8192, doc_stride=256, min_span_chars=10)
    jax_ex = JaxExtractor(params=params, config=jax_tiny_config(**OVERRIDES), **kwargs)
    jax_ex.threshold = _threshold_in_gap(jax_ex, question, contexts[:8])
    port_ex = ModelSpanExtractor(
        params=state, config=tiny_test_config(**OVERRIDES), threshold=jax_ex.threshold,
        device="cpu", **kwargs,
    )
    shapes = []
    forward = port_ex._forward_probs

    def spy(ids, mask):
        shapes.append(ids.shape)
        return forward(ids, mask)

    port_ex._forward_probs = spy
    monkeypatch.setattr(highlighter, "SLICE_TOKENS", 1000)
    got = port_ex.process_batch(question, contexts)
    assert got == jax_ex.process_batch(question, contexts)
    assert any(spans for spans in got)
    seq = shapes[0][1]
    assert len(shapes) == -(-64 // (1000 // seq)) > 1
    assert all(rows * width <= 1000 and width == seq for rows, width in shapes)


def test_extract_spans_returns_verbatim_substrings(jax_params):
    _, state = jax_params
    extractor = ModelSpanExtractor(
        params=state, config=tiny_test_config(**OVERRIDES), device="cpu", min_span_chars=5
    )

    class Result:
        def __init__(self, text):
            self.text = text

    docs = [_doc(50, 11), "", _doc(30, 12)]
    spans = extractor.extract_spans("solar energy", [Result(t) for t in docs])
    assert spans[""] == []
    for text in docs:
        assert all(span in text for span in spans[text])


#: Encoder shapes of the packed forward's cases: ModernBERT's (RoPE, a
#: global layer then local ones in a band of 16, GEGLU, pre-norm, the
#: prediction head) and BERT's (absolute positions, token type 0, post-norm),
#: each with the spread of its random weights.
PACKED_CONFIGS = {
    "modernbert": (dict(OVERRIDES, max_position_embeddings=256), (False, True), 0.3),
    "bert": (dict(max_position_embeddings=256), None, 0.1),
}

#: Live lengths of each batch's rows at S = 256: mixed lengths, an all-pad
#: row, a one-token row and a row at full length (view of 256 slots); or the
#: same kinds below one kernel key tile (view of 128 slots).
PACKED_BATCHES = {"full": [256, 0, 37, 1, 129, 200], "short": [100, 1, 0, 64, 17]}


def _packed_case(config_name, flash, lengths, seed=3):
    """An extractor over random weights scaled up so that probabilities
    spread over (0, 1), and padded ids / prefix mask for ``lengths``."""
    overrides, head, std = PACKED_CONFIGS[config_name]
    config = tiny_test_config(**dict(overrides, use_flash_attention=flash))
    generator = torch.Generator().manual_seed(seed)
    model = HighlighterModel(config, generator, cls_head_biases=head)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.normal_(1.0 if name.endswith(".scale") else 0.0, std, generator=generator)
    extractor = ModelSpanExtractor(params=model.state_dict(), config=config, device="cpu")
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, config.vocab_size, size=(len(lengths), 256)).astype(np.int32)
    mask = (np.arange(256)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    return extractor, np.where(mask == 1, ids, 0).astype(np.int32), mask


@pytest.mark.parametrize("batch", sorted(PACKED_BATCHES))
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("config_name", sorted(PACKED_CONFIGS))
def test_packed_forward_matches_padded(config_name, flash, batch):
    """The extractor's forward on live tokens alone equals the padded
    forward on every live slot, and writes exactly 0 on every pad slot."""
    extractor, ids, mask = _packed_case(config_name, flash, PACKED_BATCHES[batch])
    got = extractor._forward_probs(ids, mask)
    with torch.no_grad():
        expected = token_relevance_probs(extractor.model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    live = mask == 1
    assert got.shape == mask.shape and got.dtype == np.float32
    np.testing.assert_allclose(got[live], expected[live], rtol=5e-4, atol=5e-4)
    assert (got[~live] == 0).all()
    assert np.ptp(expected[live]) > 0.3


@pytest.mark.parametrize("batch", sorted(PACKED_BATCHES))
def test_packed_forward_launches_flash_once_a_layer_on_the_view(batch, monkeypatch):
    """One launch a layer through ``models.encoder.flash_attention`` (the
    name the benchmark's launch recorder wraps), on the [rows with a live
    token, view length, H, D] view with the rows' live lengths as int32."""
    from verbatim_rag_tpu_torch.models import encoder

    extractor, ids, mask = _packed_case("modernbert", True, PACKED_BATCHES[batch])
    config = extractor.config
    launches = []
    flash = encoder.flash_attention

    def recording(q, k, v, lengths, window=None):
        launches.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), lengths.clone(), window))
        return flash(q, k, v, lengths, window)

    monkeypatch.setattr(encoder, "flash_attention", recording)
    extractor._forward_probs(ids, mask)
    live = mask.sum(axis=1)
    live = live[live > 0]
    view = (len(live), 256 if live.max() > 128 else 128, config.num_heads, config.head_dim)
    assert len(launches) == config.num_layers
    windows = [None if config.is_global_layer(i) else config.local_attention_window for i in range(config.num_layers)]
    assert [w for *_, w in launches] == windows
    for q, k, v, lengths, _ in launches:
        assert q == k == v == view
        assert lengths.dtype == torch.int32 and lengths.tolist() == live.tolist()


def test_default_config_is_the_demo_highlighter():
    extractor = ModelSpanExtractor(device="cpu")
    assert extractor.config.hidden_size == 256 and extractor.config.num_layers == 4
    assert next(extractor.model.parameters()).device.type == "cpu"
