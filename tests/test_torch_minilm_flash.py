"""A MiniLM-shaped highlighter with flash attention on, in the PyTorch port vs the JAX package.

The config is `minilm_config(use_flash_attention=True)` narrowed to hidden
64, 2 heads of 32 (MiniLM's head dim), 2 layers, intermediate 128, 64
positions and a vocabulary of 512, computed in float32: BERT-style
(absolute positions, token types, post-LN, GELU, biases), every layer
global. On the card this shape runs the flash forward, its FA2 backward and
the ring step's partial at head dim 32; here the port takes their plain
versions and JAX its reference attention (below `FLASH_BWD_MIN_SEQ` its
`custom_vjp` takes the reference VJP). One JAX parameter tree goes to both
(`params_from_jax`), with every bias drawn from a numpy seed (the inits
zero them); inputs come from numpy seeds; JAX runs on its 8 virtual CPU
devices. Tolerances, float32 throughout:

- the parameters carried across and back: bit for bit;
- token probabilities: rtol/atol 5e-4 (the ROADMAP's float32 limit);
- one train step: the loss and every gradient rtol/atol 5e-4, each
  parameter's update ‖Δport − Δjax‖ within 1e-3 of ‖Δjax‖ (as
  `test_torch_training.py`), floored at 1e-2 of the largest update's norm
  (a key bias's true gradient is 0, so its update is weight decay and
  float noise);
- the sequence-parallel extractor against JAX's: probabilities 5e-4, spans
  equal (the threshold sits in a wide gap of the JAX probabilities).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.models.config import TrainingConfig as JaxTrainingConfig
from verbatim_rag_tpu.models.config import minilm_config as jax_minilm_config
from verbatim_rag_tpu.models.highlighter import ModelSpanExtractor as JaxExtractor
from verbatim_rag_tpu.models.highlighter import init_highlighter_params as jax_init_highlighter
from verbatim_rag_tpu.models.highlighter import token_relevance_probs as jax_probs
from verbatim_rag_tpu.models.highlighter import token_relevance_probs_sp as jax_probs_sp
from verbatim_rag_tpu.models.tokenizer import HashTokenizer as JaxTokenizer
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu.training import model as jax_model
from verbatim_rag_tpu.training import trainer as jax_trainer
from verbatim_rag_tpu_torch.models import (
    HighlighterModel,
    ModelSpanExtractor,
    params_from_jax,
    token_relevance_probs,
    token_relevance_probs_sp,
)
from verbatim_rag_tpu_torch.models.config import TrainingConfig, minilm_config
from verbatim_rag_tpu_torch.models.highlighter import params_to_jax
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
from verbatim_rag_tpu_torch.ops.ring_attention import shard_sequence
from verbatim_rag_tpu_torch.parallel import make_mesh
from verbatim_rag_tpu_torch.training import model as port_model
from verbatim_rag_tpu_torch.training import trainer as port_trainer
from verbatim_rag_tpu_torch.training.token_dataset import TokenDatasetEncoder, make_synthetic_token_data

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

NARROW = dict(
    hidden_size=64,
    num_heads=2,
    num_layers=2,
    intermediate_size=128,
    max_position_embeddings=64,
    vocab_size=512,
    use_flash_attention=True,
    compute_dtype="float32",
)
F32_RTOL = 5e-4
SEQ = 64


@pytest.fixture(scope="module")
def highlighter():
    """(JAX params, the port's model, the JAX config, the port's config)."""
    jax_config = jax_minilm_config(**NARROW)
    config = minilm_config(**NARROW)
    assert config.head_dim == 32 and config.position_embedding_type == "absolute"
    assert config.norm_location == "post" and config.type_vocab_size == 2
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "bias":
            return jnp.asarray(rng.normal(scale=0.1, size=leaf.shape).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(draw, jax_init_highlighter(jax.random.PRNGKey(7), jax_config))
    model = HighlighterModel(config)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, model, jax_config, config


def _rows(n: int = 4, seed: int = 3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, NARROW["vocab_size"], size=(n, SEQ)).astype(np.int32)
    lengths = rng.integers(SEQ // 3, SEQ + 1, size=n)
    lengths[0] = SEQ
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


def test_params_from_jax_carries_a_bert_style_highlighter(highlighter):
    """Absolute positions, token types, the post-LN norms with their biases
    and every dense bias reach the port, and go back to JAX's tree, bit for
    bit; the probabilities then agree with JAX's."""
    params, model, jax_config, _ = highlighter
    state = model.state_dict()
    for name in ("embeddings.position", "embeddings.token_type", "embeddings_ln.bias",
                 "layers.1.attn_ln.bias", "layers.1.mlp_ln.bias", "layers.0.attn.k.bias",
                 "layers.0.mlp.wo.bias", "classifier.bias"):
        assert name in state, name
    assert state["embeddings.position"].shape == (SEQ, 64) and state["embeddings.token_type"].shape == (2, 64)
    back = params_to_jax(state)
    flat_jax = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_jax) == len(flat_back)
    for path, leaf in flat_jax:
        assert np.array_equal(np.asarray(leaf), flat_back[path]), path
    ids, mask = _rows()
    expected = np.asarray(jax_probs(params, jax_config, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = token_relevance_probs(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, expected, rtol=F32_RTOL, atol=F32_RTOL)
    # The extractor's forward on the live tokens alone (absolute positions
    # gathered a token, token type 0, post-LN), with flash on and off.
    for flash in (True, False):
        config = dataclasses.replace(model.config, use_flash_attention=flash)
        packed = ModelSpanExtractor(params=state, config=config, device="cpu")._forward_probs(ids, mask)
        np.testing.assert_allclose(packed, expected * mask, rtol=F32_RTOL, atol=F32_RTOL, err_msg=f"flash={flash}")
        assert (packed[mask == 0] == 0).all()


def _token_batch(seed: int = 0):
    examples = make_synthetic_token_data(4, seed=seed)
    encoder = TokenDatasetEncoder(HashTokenizer(vocab_size=NARROW["vocab_size"]), max_length=SEQ, doc_stride=16)
    batch = next(iter(encoder.iter_batches(examples, 4)))
    assert batch.input_ids.shape == (4, SEQ) and batch.label_mask.sum() > 0
    return batch


def test_one_train_step_matches_jax(highlighter):
    """One `train_step` on both sides from the same weights and batch: the
    loss and every parameter's gradient within 5e-4, then the update."""
    params, model, jax_config, _ = highlighter
    model = HighlighterModel(model.config)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    batch = _token_batch()
    jax_batch = {f.name: jnp.asarray(getattr(batch, f.name)) for f in dataclasses.fields(batch)}
    port_batch = port_trainer.batch_to_device(batch, "cpu")

    (loss, _), grads = jax.value_and_grad(jax_model.token_loss, has_aux=True)(params, jax_config, jax_batch)
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    model.zero_grad()
    got_loss, _ = port_model.token_loss(model, port_batch)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=F32_RTOL, atol=F32_RTOL)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name] is not None, name
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=F32_RTOL, atol=F32_RTOL, err_msg=name)
    assert float(want["embeddings.position"].abs().max()) > 0

    tc = dict(learning_rate=1e-3, warmup_steps=0)
    optimizer = port_trainer.make_optimizer(TrainingConfig(**tc), model.parameters(), total_steps=4)
    jax_optimizer = jax_trainer.make_optimizer(JaxTrainingConfig(**tc), total_steps=4)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    own = jax.tree.map(lambda x: jnp.array(x, copy=True), params)  # train_step donates its params
    new_params, _, expected, _ = jax_trainer.train_step(
        own, jax_optimizer.init(own), jax_batch, jax_config, jax_optimizer, jax_model.token_loss
    )
    stepped, _ = port_trainer.train_step(model, optimizer, port_batch, port_model.token_loss)
    np.testing.assert_allclose(float(stepped), float(expected), rtol=F32_RTOL)
    jax_after = params_from_jax(jax.tree.map(np.asarray, new_params))
    updates = {name: (value - before[name], jax_after[name] - before[name]) for name, value in model.state_dict().items()}
    # A key bias's true gradient is 0 (softmax ignores a shift shared by a
    # query's logits): its update is the weight decay (≈ 1e-2 of the largest
    # update's norm here) plus AdamW's reading of float noise, which has no
    # scale of its own, so each denominator is floored at 1e-2 of the
    # largest update's norm.
    floor = 1e-2 * max(float(d_jax.norm()) for _, d_jax in updates.values())
    for name, (d_port, d_jax) in updates.items():
        assert float(d_jax.norm()) > 0, name
        assert float((d_port - d_jax).norm()) / max(float(d_jax.norm()), floor) <= 1e-3, name


def test_sp_probabilities_match_jax(highlighter):
    """`token_relevance_probs_sp` over 8 shards of 8 tokens: every layer is
    ring attention (no RoPE, so no halo), held to JAX's SP pass and to the
    port's single-device pass."""
    params, model, jax_config, _ = highlighter
    ids, mask = _rows(n=2, seed=9)
    jax_mesh = jax_make_mesh(dp=1, tp=8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(jax_mesh, P(None, "tp"))
    expected = np.asarray(
        jax_probs_sp(params, jax_config, *(jax.device_put(jnp.asarray(x), sharding) for x in (ids, mask)), jax_mesh)
    )
    mesh = make_mesh(dp=1, tp=8, devices=["cpu"] * 8)
    with torch.no_grad():
        shards = token_relevance_probs_sp(
            model, shard_sequence(torch.from_numpy(ids), mesh), shard_sequence(torch.from_numpy(mask), mesh), mesh
        )
        single = token_relevance_probs(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    got = np.concatenate([s.numpy() for s in shards], axis=1)
    np.testing.assert_allclose(got, expected, rtol=F32_RTOL, atol=F32_RTOL)
    np.testing.assert_allclose(got, single, rtol=F32_RTOL, atol=F32_RTOL)
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


def test_sp_extractor_spans_match_jax(highlighter):
    """`ModelSpanExtractor(sp_mesh=...)` on both sides: one row of at most
    64 tokens (the position table's end) in 8 shards; probabilities within
    5e-4 and spans equal."""
    params, model, jax_config, config = highlighter
    context = " ".join(f"word{i} noteworthy item{i}." for i in range(14))
    question = "what is noteworthy?"
    common = dict(max_length=SEQ, doc_stride=16, min_span_chars=10, merge_gap_chars=5)
    jax_sp = JaxExtractor(
        params=params, config=jax_config, tokenizer=JaxTokenizer(vocab_size=NARROW["vocab_size"]),
        sp_mesh=jax_make_mesh(dp=1, tp=8), **common,
    )
    jax_sp.threshold = _threshold_in_gap(jax_sp, question, context)
    port_sp = ModelSpanExtractor(
        params=model.state_dict(), config=config, tokenizer=HashTokenizer(vocab_size=NARROW["vocab_size"]),
        threshold=jax_sp.threshold, sp_mesh=make_mesh(dp=1, tp=8, devices=["cpu"] * 8), device="cpu", **common,
    )
    plan = port_sp._plan(question, context)
    assert len(plan["rows"]) == 1 and 32 < len(plan["rows"][0]) <= SEQ
    ids = np.zeros((1, SEQ), np.int32)
    mask = np.zeros((1, SEQ), np.int32)
    ids[0, : len(plan["rows"][0])] = plan["rows"][0]
    mask[0, : len(plan["rows"][0])] = 1
    np.testing.assert_allclose(
        port_sp._forward_probs(ids, mask), jax_sp._forward_probs(ids, mask), rtol=F32_RTOL, atol=F32_RTOL
    )
    expected = jax_sp.process(question, context)
    got = port_sp.process(question, context)
    assert got == expected and got
