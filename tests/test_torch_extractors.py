"""The sentence and semantic-highlight extractors of the PyTorch port vs the
JAX package, and the span-F1 evaluation over a checkpoint.

Both sides get one JAX parameter tree (the port through `params_from_jax`,
or a checkpoint written by the JAX trainer) and a tiny ModernBERT-shaped
float32 config with flash attention set (the kernel's plain version on the
CPU, JAX's Pallas kernel as its own tests run it).

Tolerances:
- sentence probabilities: rtol/atol 5e-4 against JAX's
  `predict_sentence_relevance` on JAX's own batch;
- kept sentences, spans in both modes of `SemanticHighlightExtractor`, and
  the eval CLI's printed metrics: equal. Thresholds sit inside the random
  models' spread of probabilities, so they split the sentences and tokens.
"""

from __future__ import annotations

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from verbatim_rag_tpu.models import hf_convert as jax_hf
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny
from verbatim_rag_tpu.models.highlighter import SemanticHighlightExtractor as JaxSemantic
from verbatim_rag_tpu.models.highlighter import init_highlighter_params as jax_init_highlighter
from verbatim_rag_tpu.models.sentence_extractor import SentenceModelExtractor as JaxSentence
from verbatim_rag_tpu.training import eval_f1 as jax_eval_f1
from verbatim_rag_tpu.training.dataset import QADatasetEncoder as JaxEncoder
from verbatim_rag_tpu.training.dataset import QADocument as JaxDocument
from verbatim_rag_tpu.training.dataset import Sentence as JaxSentenceRecord
from verbatim_rag_tpu.training.model import init_qa_model_params as jax_init_qa
from verbatim_rag_tpu.training.model import predict_sentence_relevance as jax_predict
from verbatim_rag_tpu.training.model import sentence_loss as jax_sentence_loss
from verbatim_rag_tpu.training.model import token_loss as jax_token_loss
from verbatim_rag_tpu.training.trainer import Trainer as JaxTrainer
from verbatim_rag_tpu_torch.core import extractors as core_extractors
from verbatim_rag_tpu_torch.models import hf_convert, highlighter
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import SemanticHighlightExtractor, params_from_jax
from verbatim_rag_tpu_torch.models.sentence_extractor import SentenceModelExtractor, split_sentences
from verbatim_rag_tpu_torch.training import eval_f1

OVERRIDES = dict(
    vocab_size=512, hidden_size=32, num_heads=2, num_layers=3, intermediate_size=32,
    max_position_embeddings=4096, position_embedding_type="rope", norm_location="pre",
    activation="geglu", use_bias=False, final_norm=True, type_vocab_size=0,
    first_layer_no_attn_norm=True, layer_norm_eps=1e-5, local_attention_window=16,
    use_flash_attention=True,
)
QUESTION = "How efficient are solar panels?"
TEXTS = [
    "Solar panels convert sunlight into electricity. Efficiency is about 22 percent! "
    "Wind turbines harvest kinetic energy.\nBatteries store the surplus for night? Grids balance it.",
    "Title line\n---\nThe panel's cells are photovoltaic. --- ... Ünïcode wörds end here.",
    "",
    "One sentence without a stop",
    " ".join(f"Sentence number {i} talks about solar energy and storage." for i in range(12)),
]


class Result:
    def __init__(self, text):
        self.text = text


@pytest.fixture(scope="module")
def qa_params():
    return jax.tree.map(np.asarray, jax_init_qa(jax.random.PRNGKey(21), jax_tiny(**OVERRIDES)))


def _extractors(params, **kw):
    theirs = JaxSentence(params=params, config=jax_tiny(**OVERRIDES), **kw)
    ours = SentenceModelExtractor(
        params=params_from_jax(params), config=tiny_test_config(**OVERRIDES), device="cpu", **kw
    )
    return ours, theirs


def _jax_probs(extractor, texts):
    """JAX's probabilities on its own batch, built as its extract_spans does."""
    spans = [
        [(s, e) for s, e in split_sentences(t) if extractor.tokenizer.tokenize_with_offsets(t[s:e])[0]]
        for t in texts
    ]
    pairs = [
        (QUESTION, JaxDocument(sentences=[JaxSentenceRecord(text=t[s:e]) for s, e in sp]))
        for t, sp in zip(texts, spans)
    ]
    batch = JaxEncoder(extractor.tokenizer, max_length=extractor.max_length,
                       max_sentences=extractor.max_sentences).encode_pairs(pairs)
    probs = jax_predict(extractor.params, extractor.config, jnp.asarray(batch.input_ids),
                        jnp.asarray(batch.attention_mask), jnp.asarray(batch.boundaries),
                        jnp.asarray(batch.sentence_mask))
    return spans, batch.sentence_mask, np.asarray(probs)


@pytest.mark.parametrize("max_length,max_sentences", [(4096, 64), (48, 4)])
def test_sentence_probabilities_match_jax(qa_params, max_length, max_sentences):
    ours, theirs = _extractors(qa_params, max_length=max_length, max_sentences=max_sentences)
    spans, mask, probs = ours.sentence_probs(QUESTION, TEXTS)
    e_spans, e_mask, e_probs = _jax_probs(theirs, TEXTS)
    assert spans == e_spans
    np.testing.assert_array_equal(mask, e_mask)
    np.testing.assert_allclose(probs * mask, e_probs * e_mask, rtol=5e-4, atol=5e-4)


def _quantile_thresholds(extractor):
    _, mask, probs = extractor.sentence_probs(QUESTION, TEXTS)
    live = probs[mask > 0]
    return [float(np.quantile(live, q)) + 1e-3 for q in (0.25, 0.5, 0.75)]


@pytest.mark.parametrize("q", range(3))
def test_kept_sentences_match_jax(qa_params, q):
    ours, _ = _extractors(qa_params)
    threshold = _quantile_thresholds(ours)[q]
    ours, theirs = _extractors(qa_params, threshold=threshold)
    results = [Result(t) for t in TEXTS]
    got = ours.extract_spans(QUESTION, results)
    assert got == theirs.extract_spans(QUESTION, results)
    kept = [s for spans in got.values() for s in spans]
    assert kept and all(any(s in t for t in TEXTS) for s in kept)


def test_no_results_and_empty_sentences(qa_params):
    ours, theirs = _extractors(qa_params)
    assert ours.extract_spans(QUESTION, []) == theirs.extract_spans(QUESTION, []) == {}
    results = [Result("--- ... !!!"), Result("")]
    assert ours.extract_spans(QUESTION, results) == theirs.extract_spans(QUESTION, results)


def test_sentence_checkpoint_from_the_jax_trainer(qa_params, tmp_path):
    """A JAX trainer's sentence checkpoint through both packages'
    `load_span_extractor`, and through ``checkpoint_dir``."""
    config = jax_tiny(**OVERRIDES)
    path = str(tmp_path / "sentence")
    JaxTrainer(qa_params, config, output_dir=path, loss_fn=jax_sentence_loss,
               total_steps=10).save_checkpoint(path)
    ours = hf_convert.load_span_extractor(path, device="cpu", threshold=0.5)
    theirs = jax_hf.load_span_extractor(path, threshold=0.5)
    assert isinstance(ours, SentenceModelExtractor) and isinstance(theirs, JaxSentence)
    from_dir = SentenceModelExtractor(config=tiny_test_config(**OVERRIDES), checkpoint_dir=path,
                                      seed=99, device="cpu")
    for key, value in ours.model.state_dict().items():
        assert np.array_equal(from_dir.model.state_dict()[key].numpy(), value.numpy()), key
    threshold = _quantile_thresholds(ours)[1]
    ours.threshold = theirs.threshold = threshold
    results = [Result(t) for t in TEXTS]
    assert ours.extract_spans(QUESTION, results) == theirs.extract_spans(QUESTION, results)


def test_params_without_a_sentence_head_are_refused():
    with pytest.raises(ValueError, match="sentence_classifier"):
        SentenceModelExtractor(params=highlighter.init_highlighter_params(
            tiny_test_config(**OVERRIDES), device="cpu").state_dict(),
            config=tiny_test_config(**OVERRIDES), device="cpu")


# -- SemanticHighlightExtractor ---------------------------------------------------------

SEMANTIC_TEXTS = [
    "Solar panels convert sunlight into electricity. Modern cells reach about twenty "
    "percent efficiency! Wind turbines harvest kinetic energy.\n\nBatteries store the "
    "surplus for the night? Grids balance supply against demand.",
    " ".join(f"Claim {i}: panels and turbines share the grid." for i in range(30)),
    "no sentence marks at all just words about solar efficiency and power output",
]


@pytest.fixture(scope="module")
def token_params():
    return jax.tree.map(np.asarray, jax_init_highlighter(jax.random.PRNGKey(8), jax_tiny(**OVERRIDES)))


@pytest.mark.parametrize("mode", ["spans", "sentences"])
@pytest.mark.parametrize("threshold", [0.45, 0.5, 0.55])
def test_semantic_highlight_modes_match_jax(token_params, mode, threshold):
    kw = dict(mode=mode, threshold=threshold, min_span_chars=4, merge_gap_chars=3, max_length=64,
              doc_stride=16)
    theirs = JaxSemantic(params=token_params, config=jax_tiny(**OVERRIDES), **kw)
    ours = SemanticHighlightExtractor(params=params_from_jax(token_params),
                                      config=tiny_test_config(**OVERRIDES), device="cpu", **kw)
    got = ours.process_batch(QUESTION, SEMANTIC_TEXTS)
    assert got == theirs.process_batch(QUESTION, SEMANTIC_TEXTS)
    assert any(got)
    jobs = [(QUESTION, [Result(t) for t in SEMANTIC_TEXTS[:2]]), ("wind", [Result(SEMANTIC_TEXTS[2])])]
    assert ours.extract_spans_multi(jobs) == theirs.extract_spans_multi(jobs)
    if mode == "sentences":
        ends = {0, *(m.end() for text in SEMANTIC_TEXTS for m in re.finditer(r"[.!?]\s+|\n+", text))}
        for text, spans in zip(SEMANTIC_TEXTS, got):
            for s, e in spans:
                assert s in ends | {len(text)} and (e in ends or e == len(text))


def test_semantic_highlight_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode must be"):
        SemanticHighlightExtractor(config=tiny_test_config(**OVERRIDES), mode="words", device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        JaxSemantic(config=jax_tiny(**OVERRIDES), mode="words")


def test_core_extractors_reexport_the_model_extractors():
    assert core_extractors.SemanticHighlightExtractor is SemanticHighlightExtractor
    assert core_extractors.ModelSpanExtractor is highlighter.ModelSpanExtractor
    with pytest.raises(AttributeError):
        core_extractors.NoSuchExtractor  # noqa: B018


# -- eval_f1 over a checkpoint ------------------------------------------------------------


def test_eval_cli_over_a_checkpoint_matches_jax(token_params, tmp_path):
    path = str(tmp_path / "token")
    JaxTrainer(token_params, jax_tiny(**OVERRIDES), output_dir=path, loss_fn=jax_token_loss,
               total_steps=10).save_checkpoint(path)
    rows = [
        {"question": QUESTION, "context": SEMANTIC_TEXTS[0], "answers": ["Modern cells reach about twenty percent"]},
        {"question": "wind?", "context": SEMANTIC_TEXTS[1], "answers": []},
    ]
    data = tmp_path / "eval.jsonl"
    data.write_text("\n".join(json.dumps(r) for r in rows))
    args = ["--data", str(data), "--model-path", path, "--threshold", "0.5", "--min-span-chars", "4",
            "--max-length", "64", "--doc-stride", "16"]
    outs = []
    for main, extra in ((eval_f1.main, ["--device", "cpu"]), (jax_eval_f1.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(args + extra) == 0
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1] and outs[0]["n_examples"] == 2
