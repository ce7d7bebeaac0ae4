"""Where a mesh-trained model lives, in the PyTorch port vs the JAX package.

JAX's `shard_params` puts each parameter on its 8 virtual CPU devices with a
`NamedSharding`, and its jitted step keeps the parameters and the optimizer
state sharded. The port's `shard_params` gives each position (d, t) of a
``["cpu"] * 8`` mesh (dp=4, tp=2) resident leaves of its own. Checked here,
for the BERT-style and the ModernBERT-style test configs:

- placement: each leaf has the shape of JAX's shard on device (d, t) and its
  values, except GEGLU's wi, whose values are the port's `tp_slice` (the
  gate and value blocks of one shard side by side); no two positions, and
  not the unsharded module, share storage;
- gather and load: the gathered tree is the placed one; loading places again
  into the same leaves;
- the gradient sync: the unsharded gradients equal the single-device step's
  (rtol `F32_RTOL` of each tensor's norm);
- the copies: after 3 steps every copy of a tp slice and of a replicated
  parameter, and its AdamW moments, are bit-equal to the others; the bytes
  resident at each position are its leaves', their gradients' and two
  moments';
- step 1 against JAX's sharded step (loss and global gradient norm within
  `F32_RTOL`, updates within `UPDATE_RTOL`), which two planted faults must
  fail: a sync that skips one copy, and a norm taken over every copy.
"""

from __future__ import annotations

import functools

import numpy as np
import optax
import pytest
import torch

import jax

from verbatim_rag_tpu.models.config import TrainingConfig as JaxTrainingConfig
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu.parallel.mesh import shard_params as jax_shard_params
from verbatim_rag_tpu.training import trainer as jax_trainer
from verbatim_rag_tpu_torch.models.config import TrainingConfig
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax
from verbatim_rag_tpu_torch.parallel import mesh as port_mesh
from verbatim_rag_tpu_torch.parallel.mesh import make_mesh, shard_params
from verbatim_rag_tpu_torch.training import trainer as port_trainer

from test_torch_parallel_training import CONFIGS, F32_RTOL, TC, _head_setup, _model, _update_close

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

DP, TP = 4, 2
STEPS = 3


def _mesh():
    return make_mesh(dp=DP, tp=TP, devices=["cpu"] * (DP * TP))


def _jax_shard_state(sharded, device) -> dict[str, torch.Tensor]:
    """JAX's shard of every leaf on ``device``, under the port's names."""

    def local(leaf):
        (shard,) = [s for s in leaf.addressable_shards if s.device == device]
        return np.asarray(shard.data)

    return params_from_jax(jax.tree.map(local, sharded))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_placement_matches_jax_shards(name):
    params, _, model = _model(name)
    jax_mesh = jax_make_mesh(dp=DP, tp=TP)
    jax_sharded = jax_shard_params(params, jax_mesh)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mesh = _mesh()
    sharded = shard_params(model, mesh)
    geglu = model.config.activation == "geglu"
    assert all(p.device.type == "cpu" for p in model.parameters())
    for d in range(DP):
        for t in range(TP):
            want = _jax_shard_state(jax_sharded, jax_mesh.devices[d][t])
            leaves = sharded.leaves[d][t]
            assert set(leaves) == set(want)
            for key, leaf in leaves.items():
                assert leaf.is_leaf and leaf.requires_grad and leaf.device == mesh.devices[d][t], key
                assert leaf.shape == want[key].shape, (key, d, t)
                if geglu and ".mlp.wi." in key:
                    spec = sharded.specs[key]
                    expected = port_mesh.tp_slice(key, state[key], spec, model.config, TP, t)
                    assert not torch.equal(expected, want[key]), key  # the divergence by choice
                    assert torch.equal(leaf.detach(), expected), key
                else:
                    assert torch.equal(leaf.detach(), want[key]), (key, d, t)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_positions_share_no_storage(name):
    _, _, model = _model(name)
    sharded = shard_params(model, _mesh())
    pointers = [p.untyped_storage().data_ptr() for p in model.parameters()]
    pointers += [leaf.untyped_storage().data_ptr() for leaf in sharded.parameters()]
    assert len(set(pointers)) == len(pointers)
    per_position = len(dict(model.named_parameters()))
    assert len(pointers) == per_position * (1 + DP * TP)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gather_returns_the_placed_tree_and_load_places_again(name):
    _, _, model = _model(name)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sharded = shard_params(model, _mesh())
    leaves = list(sharded.parameters())
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    gathered = sharded.state_dict()
    for key, value in state.items():
        assert torch.equal(gathered[key], value), key
    other = {k: v + 1.0 for k, v in state.items()}
    sharded.load_state_dict(other)
    assert all(a is b for a, b in zip(leaves, sharded.parameters()))
    for key, value in sharded.state_dict().items():
        assert torch.equal(value, other[key]), key
    assert sharded.unequal_copies() == []


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_synced_grads_match_single_device(name):
    """The gradient sum over copies: q/k/v biases (replicated, sliced at
    use) get their gradient in a different block at each tp position."""
    _, _, _, fresh, port_loss, batches, _, _ = _head_setup("token", name)
    (batch,) = batches(1)
    single, meshed = fresh(), shard_params(fresh(), _mesh())
    port_loss(single, port_trainer.batch_to_device(batch, "cpu"))[0].backward()
    port_loss(meshed, port_trainer.batch_to_mesh(batch, meshed.mesh))[0].backward()
    meshed.sync_grads()
    got = meshed.logical_grads()
    want = {k: p.grad for k, p in single.named_parameters() if p.grad is not None}
    assert set(got) == set(want) and any(".attn.q.bias" in k for k in got) == (name == "bert")
    floor = 1e-4 * max(float(w.norm()) for w in want.values())
    for key, value in want.items():
        assert float((got[key] - value).norm()) <= F32_RTOL * max(float(value.norm()), floor), key
    assert meshed.unequal_copies() == []
    for key, positions in meshed.groups:
        grads = [meshed.leaves[d][t][key].grad for d, t in positions]
        if key in got:
            assert all(g is not None and torch.equal(g, grads[0]) for g in grads), key
        else:  # a parameter the loss does not reach (ModernBERT's layer-0 attention norm)
            assert all(g is None for g in grads), key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_copies_stay_bit_equal_over_steps(name, tmp_path):
    _, _, _, fresh, port_loss, batches, _, state = _head_setup("token", name)
    model = fresh()
    trainer = port_trainer.Trainer(model, model.config, TrainingConfig(**TC), str(tmp_path),
                                   mesh=_mesh(), loss_fn=port_loss, total_steps=8)
    sharded = trainer.model
    for batch in batches(STEPS):
        port_trainer.train_step(sharded, trainer.optimizer, trainer.batch_to_device(batch), port_loss)
    assert trainer.optimizer.count == STEPS
    assert sharded.unequal_copies() == []
    adamw = trainer.optimizer.adamw.state
    for key, positions in sharded.groups:
        copies = [sharded.leaves[d][t][key] for d, t in positions]
        for moment in ("exp_avg", "exp_avg_sq"):
            assert all(torch.equal(adamw[c][moment], adamw[copies[0]][moment]) for c in copies), (key, moment)
    moved = sharded.state_dict()
    assert all(not torch.equal(moved[k], v) for k, v in state.items())
    resident = sharded.resident_bytes(adamw)
    assert [(r["d"], r["t"]) for r in resident] == [(d, t) for d in range(DP) for t in range(TP)]
    for r in resident:
        leaves = sharded.leaves[r["d"]][r["t"]].values()
        params = sum(leaf.numel() * 4 for leaf in leaves)
        assert r["params"] == params and r["grads"] == params
        assert r["optimizer_state"] == 2 * params + 4 * len(leaves)  # two moments and a step count a leaf


# -- step 1 against JAX, and the planted faults -------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step_one(name):
    """JAX's sharded step on the token head: (first batch, loss, the
    gradients' global norm, the updated tree under the port's names)."""
    params, jax_config, jax_loss, _, _, batches, _, _ = _head_setup("token", name)
    (batch,) = batches(1)
    jax_mesh = jax_make_mesh(dp=DP, tp=TP)
    jt = jax_trainer.Trainer(params, jax_config, JaxTrainingConfig(**TC), "unused", mesh=jax_mesh,
                             loss_fn=jax_loss, total_steps=8)
    placed = jax_trainer._batch_to_device(batch, jax_mesh)
    grads = jax.jit(jax.grad(lambda p, b: jax_loss(p, jax_config, b)[0]))(jt.params, placed)
    updated, _, loss, _ = jax_trainer.train_step(jt.params, jt.opt_state, placed, jax_config, jt.optimizer, jax_loss)
    return batch, float(loss), float(optax.global_norm(grads)), params_from_jax(jax.tree.map(np.asarray, updated))


def _step_one_against_jax(name, tmp_path, plant=None):
    """The port's step 1 on the mesh held to JAX's; ``plant(trainer)``
    plants a fault first. Raises AssertionError where they differ."""
    batch, jax_loss, jax_norm, jax_after = _jax_step_one(name)
    _, _, _, fresh, port_loss, _, _, state = _head_setup("token", name)
    model = fresh()
    trainer = port_trainer.Trainer(model, model.config, TrainingConfig(**TC), str(tmp_path),
                                   mesh=_mesh(), loss_fn=port_loss, total_steps=8)
    if plant is not None:
        plant(trainer)
    loss, _ = port_trainer.train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), port_loss)
    np.testing.assert_allclose(float(loss), jax_loss, rtol=F32_RTOL)
    np.testing.assert_allclose(trainer.optimizer.grad_norm, jax_norm, rtol=F32_RTOL)
    assert trainer.optimizer.grad_norm > TC["max_grad_norm"]  # clipping acted
    _update_close(trainer.model.state_dict(), state, jax_after, "jax")


def _sync_skipping_a_copy(trainer, monkeypatch):
    kept = port_mesh.grad_sum
    monkeypatch.setattr(port_mesh, "grad_sum", lambda grads, device: kept(grads[:-1] or grads, device))


def _norm_over_every_copy(trainer, monkeypatch):
    trainer.optimizer.norm_params = trainer.optimizer.params


FAULTS = {"sync skips a copy": _sync_skipping_a_copy, "norm over every copy": _norm_over_every_copy}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_one_matches_jax(name, tmp_path):
    _step_one_against_jax(name, tmp_path)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_one_fails_a_planted_fault(name, fault, tmp_path, monkeypatch):
    with pytest.raises(AssertionError):
        _step_one_against_jax(name, tmp_path, lambda trainer: FAULTS[fault](trainer, monkeypatch))
