"""Extractor training in the PyTorch port vs the JAX package.

Both sides start from one JAX parameter tree (the port through
`params_from_jax`) on a small ModernBERT shape with global and local layers
and head_dim 64 (hidden 128, 2 heads, 3 layers, window 16, vocab 512), and
get the same numpy batches.

- Losses and their aux counts (`token_loss`, `sentence_loss`): float32
  rtol 5e-4 (the ROADMAP's float32 limit); bf16 compute 2e-2 relative
  (bf16 operands are rounded at other points of the two graphs). Aux counts
  are equal.
- Three `train_step`s from one `TrainingConfig` (warmup 2, a norm limit
  small enough that clipping acts on every step): losses within 5e-4
  relative; every parameter's total update ‖Δport − Δjax‖/‖Δjax‖ ≤ 1e-3.
- Checkpoints both ways: a port checkpoint loads with the JAX
  `Trainer.load_checkpoint` and `load_span_extractor`, a JAX checkpoint
  into the port's `ModelSpanExtractor(model_path=...)`; token probabilities
  agree within 5e-4 and the parameters bit for bit.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from verbatim_rag_tpu.models.config import TrainingConfig as JaxTrainingConfig
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.hf_convert import load_span_extractor as jax_load_span_extractor
from verbatim_rag_tpu.models.highlighter import init_highlighter_params as jax_init_highlighter
from verbatim_rag_tpu.models.highlighter import token_relevance_probs as jax_probs
from verbatim_rag_tpu.training import model as jax_model
from verbatim_rag_tpu.training import trainer as jax_trainer
from verbatim_rag_tpu_torch.models.config import TrainingConfig, tiny_test_config
from verbatim_rag_tpu_torch.models.hf_convert import detect_checkpoint_format, load_span_extractor
from verbatim_rag_tpu_torch.models.highlighter import (
    HighlighterModel,
    ModelSpanExtractor,
    params_from_jax,
    params_to_jax,
    token_relevance_probs,
)
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
from verbatim_rag_tpu_torch.parallel.mesh import make_mesh
from verbatim_rag_tpu_torch.training import model as port_model
from verbatim_rag_tpu_torch.training import train as train_cli
from verbatim_rag_tpu_torch.training import trainer as port_trainer
from verbatim_rag_tpu_torch.training.dataset import QADatasetEncoder, make_synthetic_qadata
from verbatim_rag_tpu_torch.training.token_dataset import (
    TokenDatasetEncoder,
    make_synthetic_token_data,
)

OVERRIDES = dict(
    vocab_size=512,
    hidden_size=128,
    num_heads=2,
    num_layers=3,
    intermediate_size=128,
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
F32_RTOL = 5e-4
BF16_RTOL = 2e-2


def _configs(compute_dtype="float32"):
    return (
        tiny_test_config(**OVERRIDES, compute_dtype=compute_dtype),
        jax_tiny_config(**OVERRIDES, compute_dtype=compute_dtype),
    )


def _token_batches(n_batches, batch_size=4, seed=0):
    examples = make_synthetic_token_data(n_batches * batch_size, seed=seed)
    encoder = TokenDatasetEncoder(HashTokenizer(vocab_size=512), max_length=128, doc_stride=32)
    return list(encoder.iter_batches(examples, batch_size))[:n_batches]


def _sentence_batches(n_batches, batch_size=4, seed=0):
    samples = make_synthetic_qadata(n_batches * batch_size, sentences_per_doc=5, seed=seed).samples
    encoder = QADatasetEncoder(HashTokenizer(vocab_size=512), max_length=128, max_sentences=8)
    return list(encoder.iter_batches(samples, batch_size))[:n_batches]


HEADS = {
    # head: (JAX init, JAX loss, port model class, port loss, batches)
    "token": (jax_init_highlighter, jax_model.token_loss, HighlighterModel, port_model.token_loss, _token_batches),
    "sentence": (jax_model.init_qa_model_params, jax_model.sentence_loss, port_model.QAModel, port_model.sentence_loss, _sentence_batches),
}


def _setup(head, compute_dtype="float32", seed=3):
    jax_init, jax_loss, port_cls, port_loss, batches = HEADS[head]
    config, jax_config = _configs(compute_dtype)
    params = jax_init(jax.random.PRNGKey(seed), jax_config)
    model = port_cls(config)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, jax_config, jax_loss, model, config, port_loss, batches


def _jax_batch(batch):
    return {f.name: jnp.asarray(getattr(batch, f.name)) for f in dataclasses.fields(batch)}


def _port_batch(batch):
    return port_trainer.batch_to_device(batch, "cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_losses_and_aux_match_jax(head, compute_dtype):
    params, jax_config, jax_loss, model, _, port_loss, batches = _setup(head, compute_dtype)
    rtol = F32_RTOL if compute_dtype == "float32" else BF16_RTOL
    for batch in batches(2):
        expected, expected_aux = jax_loss(params, jax_config, _jax_batch(batch))
        with torch.no_grad():
            got, aux = port_loss(model, _port_batch(batch))
        np.testing.assert_allclose(float(got), float(expected), rtol=rtol)
        assert set(aux) == set(expected_aux)
        if compute_dtype == "float32":  # counts of argmax decisions: equal
            for key in aux:
                assert float(aux[key]) == float(expected_aux[key]), key


def test_sentence_relevance_matches_jax():
    params, jax_config, _, model, _, _, batches = _setup("sentence")
    (batch,) = batches(1)
    args = ("input_ids", "attention_mask", "boundaries", "sentence_mask")
    expected = jax_model.predict_sentence_relevance(
        params, jax_config, *(jnp.asarray(getattr(batch, a)) for a in args)
    )
    got = port_model.predict_sentence_relevance(
        model, *(torch.from_numpy(getattr(batch, a)) for a in args)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=F32_RTOL, atol=F32_RTOL)


def _flat(state):
    return {k: v.detach().clone() for k, v in state.items()}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_three_train_steps_match_jax(head):
    params, jax_config, jax_loss, model, config, port_loss, batches = _setup(head)
    tc = dict(learning_rate=1e-3, warmup_steps=2, max_grad_norm=0.05)
    optimizer = port_trainer.make_optimizer(TrainingConfig(**tc), model.parameters(), total_steps=8)
    jax_optimizer = jax_trainer.make_optimizer(JaxTrainingConfig(**tc), total_steps=8)
    opt_state = jax_optimizer.init(params)
    before = _flat(model.state_dict())
    for batch in batches(3):
        params, opt_state, expected, _ = jax_trainer.train_step(
            params, opt_state, _jax_batch(batch), jax_config, jax_optimizer, jax_loss
        )
        got, _ = port_trainer.train_step(model, optimizer, _port_batch(batch), port_loss)
        np.testing.assert_allclose(float(got), float(expected), rtol=F32_RTOL)
        assert optimizer.grad_norm > tc["max_grad_norm"]  # clipping acted
    assert optimizer.count == 3
    jax_after = params_from_jax(jax.tree.map(np.asarray, params))
    for name, value in model.state_dict().items():
        d_port = value - before[name]
        d_jax = jax_after[name] - before[name]
        assert float(d_jax.norm()) > 0, name
        assert float((d_port - d_jax).norm() / d_jax.norm()) <= 1e-3, name


@pytest.mark.parametrize("warmup,total", [(0, 10), (2, 8), (5, 5), (3, 100)])
def test_schedule_matches_optax(warmup, total):
    tc = TrainingConfig(learning_rate=3e-4, warmup_steps=warmup)
    rate = port_trainer.warmup_cosine_schedule(tc, total)
    expected = (
        optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(total, warmup + 1))
        if warmup
        else optax.constant_schedule(3e-4)
    )
    # optax evaluates in float32: 1e-5 relative, and float32's cosine error
    # (≈1e-7 of the peak rate) where the decay nears 0
    for count in range(total + 3):
        np.testing.assert_allclose(rate(count), float(expected(count)), rtol=1e-5, atol=3e-4 * 1e-6)


def test_trainer_lowers_the_loss(tmp_path):
    _, _, _, model, config, port_loss, _ = _setup("token")
    trainer = port_trainer.Trainer(
        model, config, TrainingConfig(learning_rate=2e-3), output_dir=str(tmp_path),
        loss_fn=port_loss,
    )
    batches = _token_batches(3)
    result = trainer.train(batches, num_epochs=4)
    losses = [r["train_loss"] for r in result["history"]]
    assert losses[-1] < 0.7 * losses[0]
    assert len(trainer.steps) == 12 and trainer.oom_skips == 0
    assert all(np.isfinite(s["grad_norm"]) for s in trainer.steps)
    assert (tmp_path / "final" / "params.npz").exists()
    assert json.loads((tmp_path / "metrics.json").read_text())["history"] == result["history"]


def test_oom_batch_is_skipped(tmp_path):
    _, _, _, model, config, port_loss, _ = _setup("token")
    calls = []

    def flaky_loss(m, batch):
        calls.append(1)
        if len(calls) == 3:  # the last batch: its gradients must be dropped
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return port_loss(m, batch)

    trainer = port_trainer.Trainer(model, config, output_dir=str(tmp_path), loss_fn=flaky_loss)
    trainer.train(_token_batches(3), num_epochs=1)
    assert trainer.oom_skips == 1 and len(trainer.steps) == 2 and trainer.optimizer.count == 2
    assert all(p.grad is None for p in model.parameters())


def _probe(seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 512, size=(3, 64)).astype(np.int32)
    mask = (np.arange(64)[None, :] < np.array([[64], [41], [9]])).astype(np.int32)
    return ids, mask


def test_port_checkpoint_loads_in_jax(tmp_path):
    params, jax_config, _, model, config, port_loss, batches = _setup("token")
    trainer = port_trainer.Trainer(model, config, TrainingConfig(learning_rate=1e-3), loss_fn=port_loss)
    port_trainer.train_step(model, trainer.optimizer, _port_batch(batches(1)[0]), port_loss)
    trainer.save_checkpoint(str(tmp_path))
    meta = json.loads((tmp_path / "verbatim_config.json").read_text())
    assert meta["head"] == "token" and meta["format"] == "verbatim-native"

    template = jax_init_highlighter(jax.random.PRNGKey(0), jax_config)
    loaded = jax_trainer.Trainer.load_checkpoint(str(tmp_path), template)
    expected = params_to_jax(model.state_dict())
    for (path, got), (_, want) in zip(
        jax.tree_util.tree_flatten_with_path(loaded)[0],
        jax.tree_util.tree_flatten_with_path(expected)[0],
    ):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(path))

    ids, mask = _probe()
    with torch.no_grad():
        got = token_relevance_probs(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    extractor = jax_load_span_extractor(str(tmp_path))
    for p, c in ((loaded, jax_config), (extractor.params, extractor.config)):
        want = np.asarray(jax_probs(p, c, jnp.asarray(ids), jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL)


def test_jax_checkpoint_serves_in_the_port(tmp_path):
    params, jax_config, _, _, _, _, _ = _setup("token", seed=11)
    jax_trainer.Trainer(params, jax_config, loss_fn=jax_model.token_loss).save_checkpoint(str(tmp_path))
    assert detect_checkpoint_format(str(tmp_path)) == "highlighter_v2"
    extractor = load_span_extractor(str(tmp_path), device="cpu")
    assert isinstance(extractor, ModelSpanExtractor)
    assert extractor.config == tiny_test_config(**OVERRIDES)
    assert extractor.tokenizer.vocab_size == 512
    ids, mask = _probe()
    with torch.no_grad():
        got = token_relevance_probs(extractor.model, torch.from_numpy(ids), torch.from_numpy(mask))
    want = np.asarray(jax_probs(params, jax_config, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=F32_RTOL)
    text = make_synthetic_token_data(1, seed=2)[0].context
    assert all(span in text for span in extractor.extract_spans("what about solar?", [_Result(text)])[text])


class _Result:
    def __init__(self, text):
        self.text = text


def test_sentence_checkpoint_round_trip_and_refusals(tmp_path):
    _, _, _, model, config, _, _ = _setup("sentence")
    trainer = port_trainer.Trainer(model, config)
    trainer.save_checkpoint(str(tmp_path / "ckpt"))
    assert json.loads((tmp_path / "ckpt" / "verbatim_config.json").read_text())["head"] == "sentence"
    fresh = port_model.init_qa_model_params(config, seed=9, device="cpu")
    port_trainer.Trainer.load_checkpoint(str(tmp_path / "ckpt"), fresh)
    for name, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name
    assert detect_checkpoint_format(str(tmp_path / "ckpt")) == "qa_model_v1"
    served = load_span_extractor(str(tmp_path / "ckpt"), device="cpu")
    assert type(served).__name__ == "SentenceModelExtractor"
    for name, value in model.state_dict().items():
        assert torch.equal(served.model.state_dict()[name], value), name
    with pytest.raises(ValueError, match="token-classification head"):
        ModelSpanExtractor(model_path=str(tmp_path / "ckpt"), device="cpu")
    (tmp_path / "hf").mkdir()
    (tmp_path / "hf" / "config.json").write_text("{}")
    with pytest.raises(KeyError, match="vocab_size"):  # the HF branch reads the config's shape
        ModelSpanExtractor(model_path=str(tmp_path / "hf"), device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        trainer.save_checkpoint(str(tmp_path / "o"), format="orbax")
    # A mesh trains (parity with JAX: tests/test_torch_parallel_training.py).
    meshed = port_trainer.Trainer(
        model, config, output_dir=str(tmp_path / "mesh"), mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    )
    result = meshed.train(_sentence_batches(1), num_epochs=1)
    assert np.isfinite(result["history"][0]["train_loss"]) and meshed.optimizer.count == 1
    assert (tmp_path / "mesh" / "final" / "params.npz").exists()


@pytest.mark.parametrize("mode", ["token", "sentence"])
def test_cli_trains_on_the_cpu(tmp_path, mode):
    data = tmp_path / "data.json"
    if mode == "token":
        records = [
            {"question": e.question, "context": e.context, "answers": [list(s) for s in e.spans], "split": e.split}
            for e in make_synthetic_token_data(10, seed=1)
        ]
        data.write_text(json.dumps(records))
    else:
        make_synthetic_qadata(10, seed=1).to_json(str(data))
    out = tmp_path / "out"
    argv = ["--data-path", str(data), "--tiny", "--mode", mode, "--device", "cpu", "--epochs", "1",
            "--batch-size", "4", "--max-seq-length", "64", "--output-dir", str(out)]
    assert train_cli.main(argv) == 0
    meta = json.loads((out / "final" / "verbatim_config.json").read_text())
    assert meta["head"] == mode and meta["encoder_config"] == dataclasses.asdict(tiny_test_config())
    if mode == "token":
        extractor = ModelSpanExtractor(model_path=str(out / "final"), device="cpu")
        assert extractor.config == tiny_test_config()
    # --dp 2 trains on a mesh of the CPU repeated twice (two rows of 4 a batch)
    assert train_cli.main([*argv, "--dp", "2", "--output-dir", str(tmp_path / "dp")]) == 0
    assert (tmp_path / "dp" / "final" / "params.npz").exists()
