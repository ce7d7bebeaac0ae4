"""Training on a mesh in the PyTorch port vs the JAX package.

The JAX side runs on its 8 virtual CPU devices, the port on meshes of
repeated ``"cpu"`` devices; one JAX parameter tree goes to both
(`params_from_jax`) and inputs come from numpy seeds. Two configs: BERT-style
(`tiny_test_config`: biases, GELU, absolute positions, plain attention) and
ModernBERT-style (RoPE, GEGLU, local and global layers, flash attention on,
no biases). Tolerances, float32 throughout:

- tensor-parallel specs: equal to JAX's spec tree, by name;
- the TP forward: rtol/atol 5e-4 on live tokens (the ROADMAP's float32 limit);
- a mesh train step: losses rtol 5e-4; each parameter's update
  ‖Δport − Δref‖/‖Δref‖ ≤ 1e-3 (as `test_torch_training.py`), against JAX's
  sharded `Trainer` and against the port's single-device step;
- ring attention's gradients: rtol 2e-4, atol 2e-5 (JAX's `TestRingGradient`);
  the SP forward's parameter gradients per tensor ‖g − g_ref‖/‖g_ref‖ ≤ 5e-4;
- checkpoints: parameters equal.

The process group's tests are in `test_torch_distributed.py` (JAX-free).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.models.config import TrainingConfig as JaxTrainingConfig
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.encoder import encoder_forward as jax_forward
from verbatim_rag_tpu.models.highlighter import init_highlighter_params as jax_init_highlighter
from verbatim_rag_tpu.ops.ring_attention import ring_attention as jax_ring
from verbatim_rag_tpu.ops.ring_attention import shard_sequence as jax_shard
from verbatim_rag_tpu.parallel.mesh import encoder_param_specs as jax_specs
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu.parallel.mesh import shard_params as jax_shard_params
from verbatim_rag_tpu.training import model as jax_model
from verbatim_rag_tpu.training import trainer as jax_trainer
from verbatim_rag_tpu_torch.models import encoder as port_encoder
from verbatim_rag_tpu_torch.models.config import TrainingConfig, tiny_test_config
from verbatim_rag_tpu_torch.models.encoder import encoder_forward_sp
from verbatim_rag_tpu_torch.models.highlighter import HighlighterModel, params_from_jax
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
from verbatim_rag_tpu_torch.ops.ring_attention import ring_attention, shard_sequence
from verbatim_rag_tpu_torch.parallel import mesh as port_mesh
from verbatim_rag_tpu_torch.parallel.mesh import ShardedModel, make_mesh, shard_params
from verbatim_rag_tpu_torch.training import model as port_model
from verbatim_rag_tpu_torch.training import train as train_cli
from verbatim_rag_tpu_torch.training import trainer as port_trainer
from verbatim_rag_tpu_torch.training.dataset import QADatasetEncoder, make_synthetic_qadata
from verbatim_rag_tpu_torch.training.token_dataset import make_synthetic_token_data

from test_torch_distributed import _ragged, _token_batches

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

F32_RTOL = 5e-4
UPDATE_RTOL = 1e-3

MODERNBERT = dict(
    vocab_size=512,
    hidden_size=256,
    num_heads=4,
    num_layers=3,
    intermediate_size=128,
    max_position_embeddings=512,
    position_embedding_type="rope",
    norm_location="pre",
    activation="geglu",
    use_bias=False,
    final_norm=True,
    type_vocab_size=0,
    first_layer_no_attn_norm=True,
    global_attn_every_n_layers=2,
    local_attention_window=16,
    layer_norm_eps=1e-5,
    use_flash_attention=True,
)
#: BERT-style (biases, GELU, absolute positions, post-norm) and ModernBERT-style.
CONFIGS = {"bert": dict(vocab_size=512, max_position_embeddings=128), "modernbert": MODERNBERT}
#: MiniLM's shape narrowed (head dim 32, flash on, every layer global: ring
#: attention only), for the SP gradients; the port's flash path on the card
#: runs the partial kernel at D = 32 there.
MINILM_FLASH = dict(
    vocab_size=512, hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128,
    max_position_embeddings=64, use_flash_attention=True,
)
SP_CONFIGS = {**CONFIGS, "minilm_flash": MINILM_FLASH}


def _with_biases(params, seed: int):
    """The tree with every bias drawn from a numpy seed (the inits zero
    them, which would hide a bias added once per shard)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if _jax_path_name(path).endswith("bias"):
            return jnp.asarray(rng.normal(scale=0.1, size=leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def _model(name: str, seed: int = 3):
    jax_config = jax_tiny_config(**SP_CONFIGS[name])
    params = _with_biases(jax_init_highlighter(jax.random.PRNGKey(seed), jax_config), seed)
    model = HighlighterModel(tiny_test_config(**SP_CONFIGS[name]))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, jax_config, model


def _rows(vocab: int, n: int = 8, seq: int = 32, seed: int = 21):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(n, seq)).astype(np.int32)
    lengths = rng.integers(seq // 3, seq + 1, size=n)
    lengths[0] = seq
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


def _jax_path_name(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def _port_path_name(name: str) -> str:
    parts = [p for p in name.split(".") if not p.isdigit()]
    if parts[0] == "embeddings_ln":
        parts = ["embeddings", "ln", *parts[1:]]
    return "/".join(parts)


# -- placement rules ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_specs_match_jax(name):
    params, _, model = _model(name)
    expected = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
        jax_specs(params), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        key = _jax_path_name(path)
        entries = tuple(spec)
        expected[key] = entries[1:] if key.startswith("layers/") and entries else entries
    got = port_mesh.encoder_param_specs(model)
    assert set(got) == set(model.state_dict())
    assert {_port_path_name(k) for k in got} == set(expected)
    for key, spec in got.items():
        assert spec == expected[_port_path_name(key)], key
    sharded = {k for k, v in got.items() if "tp" in v}
    per_layer = 6 if name == "modernbert" else 7  # q, k, v, o, wi, wo (+ wi's bias)
    assert len(sharded) == per_layer * model.config.num_layers


def test_shard_params_refuses_uneven_cuts():
    """An intermediate width that does not divide: JAX's placement refuses
    it too. Heads that do not divide over a hidden width that does: XLA
    would split a head between devices; the port, whose shards run whole
    heads, refuses."""
    mesh = make_mesh(dp=2, tp=4, devices=["cpu"] * 8)
    model = HighlighterModel(tiny_test_config(intermediate_size=66))
    with pytest.raises(ValueError, match="intermediate_size"):
        shard_params(model, mesh)
    with pytest.raises(ValueError, match="divisible"):
        jax_shard_params(
            jax_init_highlighter(jax.random.PRNGKey(0), jax_tiny_config(intermediate_size=66)),
            jax_make_mesh(dp=2, tp=4),
        )
    with pytest.raises(ValueError, match="num_heads"):
        shard_params(HighlighterModel(tiny_test_config(num_heads=2)), mesh)


def test_batch_must_divide_over_dp():
    mesh = make_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="divide evenly over dp=4"):
        port_mesh.data_sharding(torch.zeros(6, 3), mesh)
    batch = _token_batches(1, batch_size=6)[0]
    with pytest.raises(ValueError, match="dp=4"):
        port_trainer.batch_to_mesh(batch, mesh)
    shards = port_trainer.batch_to_mesh(_token_batches(1)[0], mesh)
    assert len(shards) == 4 and all(s["input_ids"].shape[0] == 2 for s in shards)


def test_geglu_shard_takes_its_block_of_both_halves():
    config = tiny_test_config(**MODERNBERT)
    inter = config.intermediate_size
    assert port_mesh.wi_columns(config, 2, 1) == [slice(64, 128), slice(inter + 64, inter + 128)]
    bert = tiny_test_config(**CONFIGS["bert"])
    assert port_mesh.wi_columns(bert, 4, 3) == [slice(48, 64)]


# -- the TP forward -------------------------------------------------------------------


def _contiguous_wi(config, tp, t):
    width = (2 if config.activation == "geglu" else 1) * config.intermediate_size // tp
    return [slice(t * width, (t + 1) * width)]


def _bias_per_shard(partials, bias, device):
    out = partials[0].to(device)
    for x in partials[1:]:
        out = out + x.to(device)
    return out if bias is None else out + bias * len(partials)


#: Planted faults the TP forward must fail: GEGLU's wi cut contiguously (shard
#: 0 would take the gate, shard 1 the value); for GELU a contiguous cut is the
#: right one, so there the replicated wo/o biases added once per shard.
FAULTS = {
    "modernbert": (port_mesh, "wi_columns", _contiguous_wi),
    "bert": (port_encoder, "tp_reduce", _bias_per_shard),
}


def _tp_forward(name, tp):
    params, jax_config, model = _model(name)
    ids, mask = _rows(jax_config.vocab_size)
    jax_mesh = jax_make_mesh(dp=8 // tp, tp=tp)
    expected = np.asarray(
        jax.jit(jax_forward, static_argnums=1)(
            jax_shard_params(params, jax_mesh), jax_config, jnp.asarray(ids), jnp.asarray(mask)
        )
    )
    sharded = shard_params(model, make_mesh(dp=8 // tp, tp=tp, devices=["cpu"] * 8))
    with torch.no_grad():
        got = sharded(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    return got, expected, mask.astype(bool)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tp_forward_matches_jax(name, tp):
    got, expected, live = _tp_forward(name, tp)
    np.testing.assert_allclose(got[live], expected[live], rtol=F32_RTOL, atol=F32_RTOL)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tp_forward_fails_a_planted_fault(name, tp, monkeypatch):
    module, attr, fault = FAULTS[name]
    monkeypatch.setattr(module, attr, fault)
    got, expected, live = _tp_forward(name, tp)
    assert not np.allclose(got[live], expected[live], rtol=F32_RTOL, atol=F32_RTOL)


def test_contiguous_wi_is_the_right_cut_without_geglu(monkeypatch):
    monkeypatch.setattr(port_mesh, "wi_columns", _contiguous_wi)
    got, expected, live = _tp_forward("bert", 2)
    np.testing.assert_allclose(got[live], expected[live], rtol=F32_RTOL, atol=F32_RTOL)


# -- a train step on the mesh ---------------------------------------------------------


def _sentence_batches(n_batches, batch_size=8, seed=0):
    samples = make_synthetic_qadata(n_batches * batch_size, sentences_per_doc=5, seed=seed).samples
    encoder = QADatasetEncoder(HashTokenizer(vocab_size=512), max_length=96, max_sentences=8)
    batches = list(encoder.iter_batches(samples, batch_size))[:n_batches]
    fields = ("labels", "sentence_mask")
    return [_ragged(b, fields, lambda b: int(b.sentence_mask.sum(1).max()), seed + i) for i, b in enumerate(batches)]


HEADS = {
    # head: (JAX init, JAX loss, port class, port loss, batches, label mask)
    "token": (jax_init_highlighter, jax_model.token_loss, HighlighterModel, port_model.token_loss,
              _token_batches, "label_mask"),
    "sentence": (jax_model.init_qa_model_params, jax_model.sentence_loss, port_model.QAModel,
                 port_model.sentence_loss, _sentence_batches, "sentence_mask"),
}
TC = dict(learning_rate=1e-3, warmup_steps=0, max_grad_norm=0.05)


def _head_setup(head, config_name="modernbert", seed=3):
    jax_init, jax_loss, port_cls, port_loss, batches, mask_key = HEADS[head]
    jax_config = jax_tiny_config(**CONFIGS[config_name])
    params = _with_biases(jax_init(jax.random.PRNGKey(seed), jax_config), seed)
    state = params_from_jax(jax.tree.map(np.asarray, params))

    def fresh():
        model = port_cls(tiny_test_config(**CONFIGS[config_name]))
        model.load_state_dict(state)
        return model

    return params, jax_config, jax_loss, fresh, port_loss, batches, mask_key, state


#: Parameters whose true gradient is 0: a key bias shifts all of a query's
#: logits alike, which softmax ignores. Adam turns their float noise into
#: full-size steps, so their updates are not compared.
ZERO_GRADIENT = ".attn.k.bias"


def _update_close(after, before, reference, what):
    for name, value in after.items():
        if name.endswith(ZERO_GRADIENT):
            continue
        d_got = value - before[name]
        d_ref = reference[name] - before[name]
        assert float(d_ref.norm()) > 0, (what, name)
        assert float((d_got - d_ref).norm() / d_ref.norm()) <= UPDATE_RTOL, (what, name)


def _mean_of_shard_means(model, batch, loss_fn, mask_key):
    """The planted fault the global mean guards against."""
    means = [loss_fn(shard, b)[0] for shard, b in zip(model.dp_shards(), batch)]
    return sum(float(m) for m in means) / len(means)


@pytest.mark.parametrize("config_name", sorted(CONFIGS))
@pytest.mark.parametrize("head", sorted(HEADS))
def test_mesh_step_matches_jax_and_single_device(head, config_name, tmp_path):
    params, jax_config, jax_loss, fresh, port_loss, batches, mask_key, state = _head_setup(head, config_name)
    (batch,) = batches(1)
    live = getattr(batch, mask_key).reshape(4, -1).sum(1)
    assert len(set(live.tolist())) > 1, live  # dp rows with different live-label counts

    jax_mesh = jax_make_mesh(dp=4, tp=2)
    jt = jax_trainer.Trainer(params, jax_config, JaxTrainingConfig(**TC), str(tmp_path / "jax"),
                             mesh=jax_mesh, loss_fn=jax_loss, total_steps=8)
    jax_params, _, jax_value, _ = jax_trainer.train_step(
        jt.params, jt.opt_state, jax_trainer._batch_to_device(batch, jax_mesh), jax_config,
        jt.optimizer, jax_loss,
    )

    model = fresh()
    trainer = port_trainer.Trainer(model, model.config, TrainingConfig(**TC), str(tmp_path / "port"),
                                   mesh=make_mesh(dp=4, tp=2, devices=["cpu"] * 8), loss_fn=port_loss,
                                   total_steps=8)
    assert isinstance(trainer.model, ShardedModel) and trainer.model.module is model
    mesh_batch = trainer.batch_to_device(batch)
    with torch.no_grad():
        global_mean = float(port_loss(trainer.model, mesh_batch)[0])
        shard_means = _mean_of_shard_means(trainer.model, mesh_batch, port_loss, mask_key)
    assert abs(shard_means - global_mean) > 10 * F32_RTOL * global_mean

    trainer.train([batch], num_epochs=1)
    single = fresh()
    optimizer = port_trainer.make_optimizer(TrainingConfig(**TC), single.parameters(), total_steps=8)
    single_value, _ = port_trainer.train_step(single, optimizer, port_trainer.batch_to_device(batch, "cpu"), port_loss)

    got = trainer.steps[0]["loss"]
    np.testing.assert_allclose(got, float(jax_value), rtol=F32_RTOL)
    np.testing.assert_allclose(got, float(single_value), rtol=F32_RTOL)
    assert trainer.optimizer.grad_norm > TC["max_grad_norm"]  # clipping acted
    np.testing.assert_allclose(trainer.optimizer.grad_norm, optimizer.grad_norm, rtol=F32_RTOL)
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    _update_close(after, state, params_from_jax(jax.tree.map(np.asarray, jax_params)), "jax")
    _update_close(after, state, single.state_dict(), "single device")


def test_mesh_evaluate_sums_counts_over_rows(tmp_path):
    _, _, _, fresh, port_loss, batches, _, _ = _head_setup("token", "bert")
    dev = batches(2)
    single = port_trainer.Trainer(fresh(), tiny_test_config(**CONFIGS["bert"]), loss_fn=port_loss)
    meshed = port_trainer.Trainer(fresh(), tiny_test_config(**CONFIGS["bert"]), loss_fn=port_loss,
                                  mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4))
    want, got = single.evaluate(dev), meshed.evaluate(dev)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=F32_RTOL, err_msg=key)


def test_mesh_checkpoint_loads_in_jax_and_unsharded(tmp_path):
    _, jax_config, _, fresh, port_loss, batches, _, _ = _head_setup("token")
    model = fresh()
    trainer = port_trainer.Trainer(model, model.config, TrainingConfig(**TC), str(tmp_path),
                                   mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4), loss_fn=port_loss)
    trainer.train(batches(1), num_epochs=1)
    final = tmp_path / "final"
    assert json.loads((final / "verbatim_config.json").read_text())["head"] == "token"
    unsharded = port_trainer.Trainer.load_checkpoint(str(final), HighlighterModel(model.config))
    template = jax_init_highlighter(jax.random.PRNGKey(0), jax_config)
    loaded = params_from_jax(jax.tree.map(np.asarray, jax_trainer.Trainer.load_checkpoint(str(final), template)))
    for name, value in model.state_dict().items():
        assert torch.equal(unsharded.state_dict()[name], value), name
        assert torch.equal(loaded[name], value), name


# -- sequence parallelism under grad --------------------------------------------------


def test_ring_gradients_match_jax():
    """JAX's `TestRingGradient` case: (1, 32, 2, 8) on 4 shards, against
    JAX's flash ring (the partial's custom VJP) and its jnp ring."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 32, 2, 8)).astype(np.float32)
    lengths = np.asarray([32], np.int32)
    jax_mesh = jax_make_mesh(dp=2, tp=4)

    def jax_loss(a, use_flash):
        shards = [jax_shard(a, jax_mesh) for _ in range(3)]
        out = jax_ring(*shards, jnp.asarray(lengths), jax_mesh, use_flash=use_flash)
        return (out.astype(jnp.float32) ** 2).sum()

    mesh = make_mesh(dp=1, tp=4, devices=["cpu"] * 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ring_attention(*(shard_sequence(xt, mesh) for _ in range(3)), torch.from_numpy(lengths), mesh)
    sum((o.float() ** 2).sum() for o in out).backward()
    got = xt.grad.numpy()
    assert np.abs(got).max() > 0
    for use_flash in (True, False):
        want = np.asarray(jax.grad(lambda a: jax_loss(a, use_flash))(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _relative_errors(got: dict, want: dict) -> dict:
    """‖g − g_ref‖ over ‖g_ref‖, floored at 1e-4 of the largest tensor's
    norm: a key bias's true gradient is 0 (softmax ignores a shift shared by
    a query's logits), so its float noise has no scale of its own."""
    floor = 1e-4 * max(float(w.norm()) for w in want.values())
    return {k: float((got[k] - want[k]).norm()) / max(float(want[k].norm()), floor) for k in want}


@pytest.mark.parametrize("name", sorted(SP_CONFIGS))
def test_sp_gradients_match_single_device(name):
    _, jax_config, model = _model(name)
    assert name != "minilm_flash" or model.config.head_dim == 32
    ids, mask = _rows(jax_config.vocab_size, n=2, seq=64, seed=4)
    mask[1, 40:] = 0
    probe = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 64, jax_config.hidden_size)).astype(np.float32))
    live = torch.from_numpy(mask).float()[..., None]

    def grads(hidden):
        model.zero_grad()
        ((hidden * probe) * live).sum().backward()
        return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}

    want = grads(model(torch.from_numpy(ids), torch.from_numpy(mask)))
    mesh = make_mesh(dp=1, tp=4, devices=["cpu"] * 4)
    shards = encoder_forward_sp(
        model, shard_sequence(torch.from_numpy(ids), mesh), shard_sequence(torch.from_numpy(mask), mesh), mesh
    )
    got = grads(torch.cat(shards, dim=1))
    assert set(got) == set(want) and "embeddings.word" in got
    errors = _relative_errors(got, want)
    assert max(errors.values()) <= F32_RTOL, errors


# -- the CLI ------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_args", [["--dp", "2"], ["--dp", "2", "--tp", "2"], ["--tp", "2"]])
def test_cli_trains_on_a_cpu_mesh(tmp_path, mesh_args):
    data = tmp_path / "data.json"
    records = [
        {"question": e.question, "context": e.context, "answers": [list(s) for s in e.spans], "split": e.split}
        for e in make_synthetic_token_data(8, seed=1)
    ]
    data.write_text(json.dumps(records))
    out = tmp_path / "out"
    argv = ["--data-path", str(data), "--tiny", "--mode", "token", "--device", "cpu", "--epochs", "1",
            "--batch-size", "4", "--max-seq-length", "64", "--output-dir", str(out), *mesh_args]
    assert train_cli.main(argv) == 0
    meta = json.loads((out / "final" / "verbatim_config.json").read_text())
    assert meta["head"] == "token" and meta["encoder_config"] == dataclasses.asdict(tiny_test_config())
    dp, tp = (2 if "--dp" in mesh_args else None), (2 if "--tp" in mesh_args else 1)
    mesh = train_cli.train_mesh(dp, tp, "cpu")
    assert mesh.size == mesh.shape["dp"] * mesh.shape["tp"] and mesh.flat_devices == [torch.device("cpu")] * mesh.size
    assert train_cli.train_mesh(None, 1, "cpu") is None
