"""Checkpoints in and out on the PyTorch port vs the JAX package.

HuggingFace directories are built here, offline: a WordPiece
``tokenizer.json`` trained in-process and `save_pretrained` of random-init
`ModernBertForTokenClassification` and `BertForTokenClassification` models,
plus a sentence-head directory (a `BertModel` with a ``sentence_classifier``
in its weights) and a ``pytorch_model.bin`` copy of the BERT one. The same
directories go through the JAX loaders and the port's.

Tolerances:
- converted parameter trees (every converter, both loaders): keys equal,
  leaves bit-equal; configs equal field by field;
- `detect_checkpoint_format`: equal on every kind of directory;
- `modernbert_params_to_hf_state_dict`: equal to JAX's and to the original
  ``model.safetensors``, and it converts back to the same tree;
- `HFTokenizer.encode_batch`: ids, mask and offsets equal;
- float32 forwards of the loaded models: token probabilities at rtol/atol
  5e-4 against JAX's (and against transformers' own forward);
- spans: equal;
- `jax_checkpoint_to_hf_dir`: the staged files byte-equal to JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.models import hf_convert as jax_hf
from verbatim_rag_tpu.models import highlighter as jax_highlighter
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny
from verbatim_rag_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer
from verbatim_rag_tpu.training.model import init_qa_model_params as jax_init_qa
from verbatim_rag_tpu.training.model import sentence_loss as jax_sentence_loss
from verbatim_rag_tpu.training.model import token_loss as jax_token_loss
from verbatim_rag_tpu.training.trainer import Trainer as JaxTrainer
from verbatim_rag_tpu.utils.upload_to_hub import jax_checkpoint_to_hf_dir as jax_stage
from verbatim_rag_tpu_torch.models import hf_convert
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import (
    ModelSpanExtractor,
    params_from_jax,
    params_to_jax,
    token_relevance_probs,
)
from verbatim_rag_tpu_torch.models.providers import provider_from_config
from verbatim_rag_tpu_torch.models.sentence_extractor import SentenceModelExtractor
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer, HFTokenizer, train_wordpiece_tokenizer
from verbatim_rag_tpu_torch.training.model import init_qa_model_params
from verbatim_rag_tpu_torch.training.trainer import Trainer
from verbatim_rag_tpu_torch.utils.upload_to_hub import jax_checkpoint_to_hf_dir

CORPUS = [
    "Solar panels convert sunlight directly into electricity using photovoltaic cells.",
    "Wind turbines capture kinetic energy from moving air and turn it into power.",
    "Hydroelectric dams exploit falling water to spin turbines connected to generators.",
    "Batteries store electrical energy chemically for later discharge on demand.",
    "The efficiency of modern photovoltaic cells exceeds twenty percent in production.",
]
QUESTION = "how efficient are solar panels"
ROPE = dict(
    position_embedding_type="rope", norm_location="pre", activation="geglu", use_bias=False,
    final_norm=True, type_vocab_size=0, first_layer_no_attn_norm=True,
    global_attn_every_n_layers=2, local_attention_window=8, num_layers=2,
)
HF_KINDS = ("modernbert", "bert", "sentence", "bert_bin")


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """One directory per kind: config.json, weights and tokenizer.json."""
    from safetensors.numpy import load_file, save_file
    from transformers import (
        BertConfig,
        BertForTokenClassification,
        BertModel,
        ModernBertConfig,
        ModernBertForTokenClassification,
    )

    root = tmp_path_factory.mktemp("hf")
    tok_file = root / "tokenizer.json"
    tok = train_wordpiece_tokenizer(tok_file, CORPUS, vocab_size=400)
    vocab = tok.get_vocab_size()
    dirs, models = {}, {}

    mb_config = ModernBertConfig(
        vocab_size=vocab, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=48, max_position_embeddings=128, global_attn_every_n_layers=2,
        local_attention=8, pad_token_id=tok.token_to_id("[PAD]"), bos_token_id=2, eos_token_id=3,
        cls_token_id=2, sep_token_id=3, num_labels=2, attention_dropout=0.0, mlp_dropout=0.0,
        embedding_dropout=0.0, classifier_dropout=0.0,
    )
    bert_config = BertConfig(
        vocab_size=vocab, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=48, max_position_embeddings=128, num_labels=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
    )
    torch.manual_seed(7)
    models["modernbert"] = ModernBertForTokenClassification(mb_config).eval()
    torch.manual_seed(8)
    models["bert"] = BertForTokenClassification(bert_config).eval()
    torch.manual_seed(9)
    sentence = BertModel(bert_config, add_pooling_layer=False).eval()
    for kind, model in (("modernbert", models["modernbert"]), ("bert", models["bert"]),
                        ("sentence", sentence)):
        out = root / kind
        model.save_pretrained(str(out), safe_serialization=True)
        shutil.copy(tok_file, out / "tokenizer.json")
        dirs[kind] = str(out)
    # The sentence head rides in the weights, as the reference's qa_model-v1 saves it.
    st = os.path.join(dirs["sentence"], "model.safetensors")
    sd = load_file(st)
    rng = np.random.default_rng(3)
    sd["sentence_classifier.weight"] = rng.standard_normal((2, 32)).astype(np.float32)
    sd["sentence_classifier.bias"] = np.zeros(2, np.float32)
    save_file(sd, st, metadata={"format": "pt"})
    # The same BERT weights as pytorch_model.bin.
    out = root / "bert_bin"
    models["bert"].save_pretrained(str(out), safe_serialization=False)
    shutil.copy(tok_file, out / "tokenizer.json")
    dirs["bert_bin"] = str(out)
    models["bert_bin"] = models["bert"]
    return dirs, models


def _assert_trees_equal(got, expected, path=""):
    assert set(got) == set(expected), (path, sorted(got), sorted(expected))
    for key, value in expected.items():
        if isinstance(value, dict):
            _assert_trees_equal(got[key], value, f"{path}/{key}")
        else:
            np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=f"{path}/{key}")
            assert got[key].dtype == np.float32


def _jax_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kind", HF_KINDS)
def test_hf_loaders_convert_like_jax(hf_dirs, kind):
    dirs, _ = hf_dirs
    jax_params, jax_config, _ = jax_hf.load_highlighter_checkpoint(dirs[kind])
    tree, config = hf_convert.load_hf_params(dirs[kind])
    _assert_trees_equal(tree, _jax_tree(jax_params))
    assert dataclasses.asdict(config) == dataclasses.asdict(jax_config)
    state, config2, tokenizer = hf_convert.load_highlighter_checkpoint(dirs[kind])
    assert isinstance(tokenizer, HFTokenizer) and config2 == config
    expected = params_from_jax(_jax_tree(jax_params))
    assert state.keys() == expected.keys()
    for key in expected:
        assert torch.equal(state[key], expected[key]), key
    assert ("cls_head.dense.kernel" in state) == (kind == "modernbert")
    assert ("classifier.kernel" in state) == (kind != "sentence")


def test_bert_converters_match_jax():
    """`convert_bert_state_dict` with a prefix and `convert_bert_mlm_head` on a
    `BertForMaskedLM` state dict (the SPLADE backbone)."""
    from transformers import BertConfig, BertForMaskedLM

    config = BertConfig(vocab_size=300, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=48, max_position_embeddings=64)
    torch.manual_seed(11)
    sd = BertForMaskedLM(config).state_dict()
    enc_config = hf_convert.config_from_hf(config.to_dict())
    jax_config = jax_hf.config_from_hf(config.to_dict())
    assert dataclasses.asdict(enc_config) == dataclasses.asdict(jax_config)
    got = hf_convert.convert_bert_mlm_head(sd, hf_convert.convert_bert_state_dict(sd, enc_config, "bert."))
    expected = jax_hf.convert_bert_mlm_head(sd, jax_hf.convert_bert_state_dict(sd, jax_config, "bert."))
    _assert_trees_equal(got, _jax_tree(expected))


def _native_dir(tmp_path, head: str, hf_tokenizer_path: str | None = None):
    """A JAX trainer checkpoint of a tiny ModernBERT-shaped model."""
    config = jax_tiny(**ROPE)
    if head == "sentence":
        params, loss = jax_init_qa(jax.random.PRNGKey(5), config), jax_sentence_loss
    else:
        params, loss = jax_highlighter.init_highlighter_params(jax.random.PRNGKey(5), config), jax_token_loss
    path = str(tmp_path / f"native_{head}")
    tokenizer = JaxHFTokenizer(hf_tokenizer_path) if hf_tokenizer_path else None
    JaxTrainer(params, config, output_dir=path, loss_fn=loss, total_steps=10,
               tokenizer=tokenizer).save_checkpoint(path)
    return path


def test_detect_checkpoint_format_matches_jax(hf_dirs, tmp_path):
    dirs, _ = hf_dirs
    paths = dict(dirs)
    paths["native_token"] = _native_dir(tmp_path, "token")
    paths["native_sentence"] = _native_dir(tmp_path, "sentence")
    auto = tmp_path / "auto_map"
    shutil.copytree(dirs["sentence"], auto)
    cfg = json.loads((auto / "config.json").read_text())
    cfg["auto_map"] = {"AutoModel": "modeling.HighlighterModel"}
    (auto / "config.json").write_text(json.dumps(cfg))
    paths["auto_map"] = str(auto)
    got = {kind: hf_convert.detect_checkpoint_format(p) for kind, p in paths.items()}
    assert got == {kind: jax_hf.detect_checkpoint_format(p) for kind, p in paths.items()}
    assert got["sentence"] == got["native_sentence"] == "qa_model_v1"
    assert got["auto_map"] == got["modernbert"] == got["bert"] == "highlighter_v2"


def test_round_trip_through_the_hf_state_dict(hf_dirs):
    from safetensors.numpy import load_file

    dirs, _ = hf_dirs
    tree, config = hf_convert.load_hf_params(dirs["modernbert"])
    jax_params, jax_config, _ = jax_hf.load_highlighter_checkpoint(dirs["modernbert"])
    inverted = hf_convert.modernbert_params_to_hf_state_dict(tree, config)
    expected = jax_hf.modernbert_params_to_hf_state_dict(jax_params, jax_config)
    original = load_file(os.path.join(dirs["modernbert"], "model.safetensors"))
    assert list(inverted) == list(expected) and set(inverted) == set(original)
    for key in original:
        np.testing.assert_array_equal(inverted[key], expected[key], err_msg=key)
        np.testing.assert_array_equal(inverted[key], original[key], err_msg=key)
        assert inverted[key].flags["C_CONTIGUOUS"]
    back = hf_convert.convert_modernbert_state_dict(inverted, config, prefix="model.")
    _assert_trees_equal(back, {k: v for k, v in tree.items() if k in back})


@pytest.mark.parametrize("kind", ["modernbert", "bert"])
def test_hf_config_round_trip_matches_jax(hf_dirs, kind):
    dirs, _ = hf_dirs
    _, config = hf_convert.load_hf_params(dirs[kind])
    _, jax_config, _ = jax_hf.load_highlighter_checkpoint(dirs[kind])
    exported = hf_convert.hf_config_from_encoder(config, num_labels=3)
    assert exported == jax_hf.hf_config_from_encoder(jax_config, num_labels=3)
    assert dataclasses.asdict(hf_convert.config_from_hf(exported)) == dataclasses.asdict(
        jax_hf.config_from_hf(exported)
    )


TOKENIZER_CASES = [
    (CORPUS[:2], None, 512),
    (["Solar panels convert Sunlight into electricity, efficiently."], None, 128),
    ([QUESTION, "wind?"], [CORPUS[0] + " " + CORPUS[4], CORPUS[1]], 64),
    ([" ".join(CORPUS * 4)], None, 70),
    (["Ünïcode wörds — and [UNK] pieces"], ["ok"], 512),
]


@pytest.mark.parametrize("texts,pair,max_length", TOKENIZER_CASES)
def test_hf_tokenizer_encode_batch_matches_jax(hf_dirs, texts, pair, max_length):
    dirs, _ = hf_dirs
    path = os.path.join(dirs["bert"], "tokenizer.json")
    ours, theirs = HFTokenizer(path), JaxHFTokenizer(path)
    assert (ours.pad_id, ours.cls_id, ours.sep_id, ours.vocab_size) == (
        theirs.pad_id, theirs.cls_id, theirs.sep_id, theirs.vocab_size
    )
    assert ours.describe() == theirs.describe()
    got = ours.encode_batch(texts, max_length=max_length, pair=pair, with_offsets=True)
    expected = theirs.encode_batch(texts, max_length=max_length, pair=pair, with_offsets=True)
    np.testing.assert_array_equal(got.input_ids, expected.input_ids)
    np.testing.assert_array_equal(got.attention_mask, expected.attention_mask)
    assert got.offsets == expected.offsets
    assert got.input_ids.dtype == np.int32


def _probs_inputs(tokenizer):
    enc = tokenizer.encode_batch(
        [QUESTION, "what do wind turbines do"], max_length=128,
        pair=[CORPUS[0] + " " + CORPUS[4], CORPUS[1]],
    )
    return enc.input_ids, enc.attention_mask


@pytest.mark.parametrize("kind", ["modernbert", "bert", "bert_bin"])
def test_float32_forward_of_a_loaded_checkpoint_matches_jax(hf_dirs, kind):
    dirs, models = hf_dirs
    state, config, tokenizer = hf_convert.load_highlighter_checkpoint(dirs[kind])
    jax_params, jax_config, _ = jax_hf.load_highlighter_checkpoint(dirs[kind])
    config = dataclasses.replace(config, compute_dtype="float32")
    jax_config = dataclasses.replace(jax_config, compute_dtype="float32")
    ids, mask = _probs_inputs(tokenizer)
    extractor = ModelSpanExtractor(params=state, config=config, tokenizer=tokenizer, device="cpu")
    with torch.no_grad():
        got = token_relevance_probs(extractor.model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    expected = np.asarray(
        jax_highlighter.token_relevance_probs(jax_params, jax_config, jnp.asarray(ids), jnp.asarray(mask))
    )
    np.testing.assert_allclose(got, expected, rtol=5e-4, atol=5e-4)
    with torch.no_grad():
        logits = models[kind](input_ids=torch.from_numpy(ids).long(),
                              attention_mask=torch.from_numpy(mask).long()).logits
    reference = torch.softmax(logits.float(), dim=-1)[..., 1].numpy() * mask
    np.testing.assert_allclose(got, reference, rtol=5e-4, atol=5e-4)


# Thresholds inside each random model's spread of token probabilities.
SPAN_CASES = [("modernbert", 0.3), ("modernbert", 0.55), ("modernbert", 0.75),
              ("bert", 0.46), ("bert", 0.47), ("bert", 0.49)]


@pytest.mark.parametrize("kind,threshold", SPAN_CASES)
def test_spans_of_a_loaded_checkpoint_match_jax(hf_dirs, kind, threshold):
    dirs, _ = hf_dirs
    state, config, tokenizer = hf_convert.load_highlighter_checkpoint(dirs[kind])
    jax_params, jax_config, jax_tokenizer = jax_hf.load_highlighter_checkpoint(dirs[kind])
    kw = dict(threshold=threshold, min_span_chars=5, merge_gap_chars=4, max_length=48, doc_stride=8)
    ours = ModelSpanExtractor(params=state, config=dataclasses.replace(config, compute_dtype="float32"),
                              tokenizer=tokenizer, device="cpu", **kw)
    theirs = jax_highlighter.ModelSpanExtractor(
        params=jax_params, config=dataclasses.replace(jax_config, compute_dtype="float32"),
        tokenizer=jax_tokenizer, **kw,
    )
    contexts = [CORPUS[0], " ".join(CORPUS), CORPUS[3] + " " + CORPUS[2], "   "]
    got = ours.process_batch(QUESTION, contexts)
    assert got == theirs.process_batch(QUESTION, contexts)
    assert any(got)


@pytest.mark.parametrize("kind", ["modernbert", "bert"])
def test_load_span_extractor_serves_an_hf_directory(hf_dirs, kind):
    """Threshold 0 selects every context token, so the span runs from the
    first context character to the last: the offsets through the windows."""
    dirs, _ = hf_dirs
    long_context = " ".join(CORPUS * 6)
    kw = dict(threshold=0.0, min_span_chars=1, merge_gap_chars=10_000, max_length=64, doc_stride=8)
    ours = hf_convert.load_span_extractor(dirs[kind], device="cpu", **kw)
    theirs = jax_hf.load_span_extractor(dirs[kind], **kw)
    assert type(ours).__name__ == type(theirs).__name__ == "ModelSpanExtractor"
    got = ours.process("energy", long_context)
    assert got == theirs.process("energy", long_context) == [(0, len(long_context))]


def test_sentence_hf_directory_is_refused_without_its_head(hf_dirs):
    """The HF branch, like JAX's, reads no ``sentence_classifier``; the port
    refuses at construction (JAX builds the extractor and fails in its first
    forward)."""
    dirs, _ = hf_dirs
    with pytest.raises(ValueError, match="sentence_classifier"):
        hf_convert.load_span_extractor(dirs["sentence"], device="cpu")
    with pytest.raises(ValueError, match="token-classification head"):
        ModelSpanExtractor(model_path=dirs["sentence"], device="cpu")


def test_hf_directory_without_tokenizer_json_is_refused(hf_dirs, tmp_path):
    dirs, _ = hf_dirs
    bare = tmp_path / "bare"
    bare.mkdir()
    for name in ("config.json", "model.safetensors"):
        shutil.copy(os.path.join(dirs["modernbert"], name), bare / name)
    with pytest.raises(Exception):
        jax_hf.load_highlighter_checkpoint(str(bare))
    with pytest.raises(Exception):
        hf_convert.load_highlighter_checkpoint(str(bare))


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read() for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("extra", [None, {"license": "apache-2.0"}])
def test_staging_writes_jax_files(hf_dirs, tmp_path, extra):
    dirs, _ = hf_dirs
    ckpt = _native_dir(tmp_path, "token", os.path.join(dirs["bert"], "tokenizer.json"))
    jax_stage(ckpt, str(tmp_path / "jax"), extra)
    jax_checkpoint_to_hf_dir(ckpt, str(tmp_path / "port"), extra)
    got, expected = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(expected) == sorted(
        ["config.json", "model.safetensors", "params.npz", "tokenizer.json", "verbatim_config.json"]
    )
    assert got == expected


def test_staging_a_sentence_checkpoint_copies_the_native_files(tmp_path):
    ckpt = _native_dir(tmp_path, "sentence")
    jax_stage(ckpt, str(tmp_path / "jax"))
    jax_checkpoint_to_hf_dir(ckpt, str(tmp_path / "port"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert sorted(_files(tmp_path / "port")) == ["params.npz", "verbatim_config.json"]


def test_staged_weights_load_through_the_hf_branch(hf_dirs, tmp_path):
    """A port trainer checkpoint staged, then its config.json,
    model.safetensors and a tokenizer.json alone: the HF branch gives the
    trained weights exactly, and the staged directory itself (it holds
    verbatim_config.json) takes the native branch."""
    dirs, _ = hf_dirs
    config = tiny_test_config(**ROPE)
    from verbatim_rag_tpu_torch.models.highlighter import init_highlighter_params

    model = init_highlighter_params(config, seed=4, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    Trainer(model, config, output_dir=ckpt, tokenizer=HashTokenizer(config.vocab_size)).save_checkpoint(ckpt)
    staged = str(tmp_path / "staged")
    jax_checkpoint_to_hf_dir(ckpt, staged)
    hf_only = tmp_path / "hf_only"
    hf_only.mkdir()
    for name in ("config.json", "model.safetensors"):
        shutil.copy(os.path.join(staged, name), hf_only / name)
    shutil.copy(os.path.join(dirs["bert"], "tokenizer.json"), hf_only / "tokenizer.json")
    served = ModelSpanExtractor(model_path=str(hf_only), device="cpu")
    native = ModelSpanExtractor(model_path=staged, device="cpu")
    assert isinstance(served.tokenizer, HFTokenizer) and isinstance(native.tokenizer, HashTokenizer)
    shape = ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
             "local_attention_window", "global_attn_every_n_layers", "activation", "use_bias")
    assert [getattr(served.config, f) for f in shape] == [getattr(config, f) for f in shape]
    for key, value in model.state_dict().items():
        assert torch.equal(served.model.state_dict()[key], value), key
        assert torch.equal(native.model.state_dict()[key], value), key
    jax_params, _, _ = jax_hf.load_highlighter_checkpoint(str(hf_only))
    _assert_trees_equal(params_to_jax(served.model.state_dict()), _jax_tree(jax_params))


def test_native_checkpoint_with_an_hf_tokenizer_loads_it(hf_dirs, tmp_path):
    dirs, _ = hf_dirs
    tok_path = os.path.join(dirs["bert"], "tokenizer.json")
    ckpt = _native_dir(tmp_path, "sentence", tok_path)
    state, config, tokenizer = hf_convert.load_highlighter_checkpoint(ckpt)
    jax_params, jax_config, jax_tokenizer = jax_hf.load_highlighter_checkpoint(ckpt)
    assert isinstance(tokenizer, HFTokenizer) and tokenizer.describe() == jax_tokenizer.describe()
    assert dataclasses.asdict(config) == dataclasses.asdict(jax_config)
    _assert_trees_equal(params_to_jax(state), _jax_tree(jax_params))
    extractor = hf_convert.load_span_extractor(ckpt, device="cpu")
    assert isinstance(extractor, SentenceModelExtractor)


def test_provider_identity_with_an_hf_tokenizer_rebuilds(hf_dirs):
    dirs, _ = hf_dirs
    path = os.path.join(dirs["bert"], "tokenizer.json")
    identity = {
        "class": "JaxDenseProvider", "reconstructible": True, "seed": 3, "max_length": 64,
        "batch_size": 2,
        "config": dataclasses.asdict(tiny_test_config(vocab_size=512, compute_dtype="float32")),
        "tokenizer": {"class": "HFTokenizer", "path": path},
    }
    provider = provider_from_config(identity, device="cpu")
    assert isinstance(provider.tokenizer, HFTokenizer) and provider.tokenizer.path == path
    assert provider.embed_batch(CORPUS[:2]).shape == (2, 32)
    with pytest.raises(ValueError, match="no path"):
        provider_from_config({**identity, "tokenizer": {"class": "HFTokenizer"}}, device="cpu")


def test_native_round_trip_keeps_a_sentence_head(tmp_path):
    """The port's own sentence checkpoint: saved, detected and loaded."""
    config = tiny_test_config(**ROPE)
    model = init_qa_model_params(config, seed=2, device="cpu")
    path = str(tmp_path / "s")
    Trainer(model, config, output_dir=path, tokenizer=HashTokenizer(config.vocab_size)).save_checkpoint(path)
    assert hf_convert.detect_checkpoint_format(path) == jax_hf.detect_checkpoint_format(path) == "qa_model_v1"
    extractor = hf_convert.load_span_extractor(path, device="cpu")
    assert isinstance(extractor, SentenceModelExtractor)
    for key, value in model.state_dict().items():
        assert torch.equal(extractor.model.state_dict()[key], value), key
