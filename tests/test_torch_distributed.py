"""`parallel/distributed.py`: the process group and its data-parallel step.

The file imports nothing of JAX, so it runs where the port runs, the card's
machine included. JAX's rules (`verbatim_rag_tpu/parallel/distributed.py`)
are restated here: a single process initializes nothing, and a global batch
that does not divide over the processes raises. The group's step: n
processes, each on its `process_local_batch_slice` of an 8-row batch over a
``["cpu"] * 2`` mesh of its own (`make_mesh`: the group joins the meshes
along dp; `global_mesh`'s mesh across ranks is tested in
`test_torch_tp_sp_processes.py`), end with equal parameters (the gathered tree of each
mesh), within 1e-6 of one process's dp = 2·n step on the whole batch (their
sums run in another order), and every parameter moved by the step. The
`cuda`-marked case runs the same gloo step where a card is visible, so the
group holds NCCL as well and must still send CPU tensors to gloo.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from verbatim_rag_tpu_torch.models.config import TrainingConfig, tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import HighlighterModel
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
from verbatim_rag_tpu_torch.parallel import distributed
from verbatim_rag_tpu_torch.parallel.mesh import make_mesh
from verbatim_rag_tpu_torch.training import model as port_model
from verbatim_rag_tpu_torch.training import trainer as port_trainer
from verbatim_rag_tpu_torch.training.token_dataset import TokenDatasetEncoder, make_synthetic_token_data

REPO = Path(__file__).resolve().parent.parent
#: The BERT-style tiny config (biases, GELU, absolute positions).
BERT = dict(vocab_size=512, max_position_embeddings=128)


def _ragged(batch, fields, keep, seed):
    """Rows cut to different lengths from a numpy seed (the synthetic
    examples are all alike): each row keeps a random prefix of
    ``keep(batch)``'s width in ``fields``, the rest zeroed, so that dp rows
    carry different numbers of live labels."""
    width = keep(batch)
    ends = np.random.default_rng(seed).integers(width // 3, width + 1, size=batch.input_ids.shape[0])
    ends[0] = width
    cut = {}
    for name in fields:
        value = getattr(batch, name).copy()
        for row, end in enumerate(ends):
            value[row, end:] = 0
        cut[name] = value
    return dataclasses.replace(batch, **cut)


def _token_batches(n_batches, batch_size=8, seed=0):
    examples = make_synthetic_token_data(n_batches * batch_size, seed=seed)
    encoder = TokenDatasetEncoder(HashTokenizer(vocab_size=512), max_length=96, doc_stride=32)
    batches = list(encoder.iter_batches(examples, batch_size))[:n_batches]
    fields = ("input_ids", "attention_mask", "labels", "label_mask")
    return [_ragged(b, fields, lambda b: int(b.attention_mask.sum(1).max()), seed + i) for i, b in enumerate(batches)]


def test_process_local_batch_slice_follows_jax(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    with pytest.raises(ValueError, match="divide evenly"):
        distributed.process_local_batch_slice(10)
    assert distributed.process_local_batch_slice(12) == slice(3, 6)


def test_single_process_initialize_is_a_no_op(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1) is False
    assert not distributed.is_initialized()
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.process_local_batch_slice(8) == slice(0, 8)
    mesh = distributed.global_mesh(dp=2, tp=1, devices=["cpu"] * 2)
    assert mesh.shape == {"dp": 2, "tp": 1}


WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    from verbatim_rag_tpu_torch.models.config import TrainingConfig, tiny_test_config
    from verbatim_rag_tpu_torch.models.highlighter import HighlighterModel
    from verbatim_rag_tpu_torch.parallel import distributed, make_mesh
    from verbatim_rag_tpu_torch.training import trainer as port_trainer
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.token_dataset import TokenBatch

    out_path, overrides, batch_path = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    assert distributed.initialize() is True
    config = tiny_test_config(**overrides)
    model = HighlighterModel(config, torch.Generator().manual_seed(7))
    mesh = make_mesh(dp=2, tp=1, devices=["cpu"] * 2)  # this process's mesh, joined along dp by the group
    trainer = port_trainer.Trainer(model, config, TrainingConfig(learning_rate=1e-3, max_grad_norm=0.05),
                                   mesh=mesh, loss_fn=token_loss, total_steps=8)
    arrays = np.load(batch_path)
    rows = distributed.process_local_batch_slice(arrays["input_ids"].shape[0])
    local = TokenBatch(**{name: arrays[name][rows] for name in arrays.files})
    loss, _ = port_trainer.train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(local), token_loss)
    np.savez(out_path, loss=float(loss), grad_norm=trainer.optimizer.grad_norm,
             backend=str(torch.distributed.get_backend()), card_visible=torch.cuda.is_available(),
             **{k: v.detach().numpy() for k, v in trainer.model.state_dict().items()})
    torch.distributed.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_in_processes(tmp_path, n_proc: int) -> list:
    """``n_proc`` gloo processes take one step on their shares of an 8-row
    batch; held to one process's dp = 2·n_proc step. Returns the ranks'
    outputs."""
    (batch,) = _token_batches(1)
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None}
    np.savez(tmp_path / "batch.npz", **fields)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n_proc), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp_path / f"rank{rank}.npz"), json.dumps(BERT),
             str(tmp_path / "batch.npz")],
            cwd=REPO, env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(n_proc)
    ]
    try:
        outputs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * n_proc, [err[-2000:] for _, err in outputs]

    config = tiny_test_config(**BERT)
    model = HighlighterModel(config, torch.Generator().manual_seed(7))
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = port_trainer.Trainer(model, config, TrainingConfig(learning_rate=1e-3, max_grad_norm=0.05),
                                   mesh=make_mesh(dp=2 * n_proc, tp=1, devices=["cpu"] * (2 * n_proc)),
                                   loss_fn=port_model.token_loss,
                                   total_steps=8)
    loss, _ = port_trainer.train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch),
                                      port_model.token_loss)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(n_proc)]
    for name, value in trainer.model.state_dict().items():
        for other in ranks[1:]:
            np.testing.assert_array_equal(ranks[0][name], other[name], err_msg=name)
        np.testing.assert_allclose(ranks[0][name], value.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
        assert not np.array_equal(value.numpy(), initial[name].numpy()), name
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-6)
        np.testing.assert_allclose(float(r["grad_norm"]), trainer.optimizer.grad_norm, rtol=1e-5)
    expected = distributed.BACKEND if torch.distributed.is_nccl_available() else "gloo"
    assert {str(r["backend"]) for r in ranks} == {expected}
    return ranks


@pytest.mark.parametrize("n_proc", [2, 4])
def test_processes_step_as_one_process(tmp_path, n_proc):
    _step_in_processes(tmp_path, n_proc)


@pytest.mark.cuda
def test_processes_step_on_the_cpu_beside_a_card(tmp_path):
    """Where a card is visible the group holds NCCL too; a mesh of CPU
    devices must still train, its collectives on gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the group's NCCL side exists only beside a card")
    ranks = _step_in_processes(tmp_path, 2)
    assert all(bool(r["card_visible"]) for r in ranks)
    assert all("cuda:nccl" in str(r["backend"]) for r in ranks)
