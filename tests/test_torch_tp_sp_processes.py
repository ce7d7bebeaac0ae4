"""Tensor and sequence parallelism across processes: a mesh over every rank's
devices (`distributed.global_mesh`, JAX's mesh after ``jax.distributed``)
whose tp axis spans the process boundary.

Gloo processes on the CPU run three layouts, each one group:

- ``2ranks``: two ranks of one position. SP over a line of 2; TP at
  dp = 1 × tp = 2 (one position a rank); two misfit layouts.
- ``4ranks``: four ranks of one position. SP over a line of 4; TP at
  dp = 2 × tp = 2 with tp across ranks; two planted faults.
- ``2x2``: two ranks of ``["cpu"] * 2`` for SP (a line of 4, one hand-off
  inside a rank and one across), and the DCN demo's own layout for TP
  (`scripts/dcn_two_process_demo.py`): two ranks of four positions, dp = 4
  × tp = 2, dp across ranks.

(a) SP: the tiny ModernBERT config with global and local layers (window 16,
a shard ≥ 8). The forward across ranks is bit-equal to the one-process
ring over as many shards (computed in the same worker after its group is
gone), and within 5e-4 of JAX's `encoder_forward_sp` on a mesh of
conftest's virtual devices; the parameter gradients of a probe loss,
summed over the ranks, within 1e-6 (per tensor ‖g − g_ref‖/‖g_ref‖) of the
one-process SP backward; `ModelSpanExtractor(sp_mesh=<global mesh>)` gives
every rank the spans of JAX's SP extractor.

(b) TP: the demo's ``tiny_test_config(num_heads=2, intermediate_size=64)``
with ``sentence_loss`` and with the token head, an 8-row ragged batch made
from a numpy seed: step 1's loss within ``F32_RTOL`` of JAX's `train_step`
on ``make_mesh(dp=4, tp=2)`` and of the port's single-device step, its
global norm within ``F32_RTOL`` of the single-device step's, its update
within ``UPDATE_RTOL`` of both (as `test_mesh_step_matches_jax_and_single_device`);
loss and norm equal on every rank; every copy of every logical tensor
bit-equal across ranks after 2 steps; the checkpoint rank 0 writes loads
in JAX and equals the gathered tree. At dp = 1 the loss is bit-equal to the
one-process mesh's.

(c) Planted faults fail: K/V rotated j → j − 1 at the rank boundary (the SP
forward then differs from the one-process ring), and the loss counts summed
over the whole group instead of the dp column (step 1's loss then misses
JAX's). A mesh that does not fit the ranks' devices raises on every rank,
within the spawn's timeout.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from verbatim_rag_tpu.models.config import TrainingConfig as JaxTrainingConfig
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.encoder import encoder_forward_sp as jax_forward_sp
from verbatim_rag_tpu.models.encoder import init_encoder_params as jax_init_encoder
from verbatim_rag_tpu.models.highlighter import ModelSpanExtractor as JaxExtractor
from verbatim_rag_tpu.models.highlighter import init_highlighter_params as jax_init_highlighter
from verbatim_rag_tpu.models.tokenizer import HashTokenizer as JaxTokenizer
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu.training import model as jax_model
from verbatim_rag_tpu.training import trainer as jax_trainer
from verbatim_rag_tpu_torch.models.config import TrainingConfig, tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import HighlighterModel, params_from_jax
from verbatim_rag_tpu_torch.training import model as port_model
from verbatim_rag_tpu_torch.training import trainer as port_trainer
from verbatim_rag_tpu_torch.training.dataset import EncodedBatch
from verbatim_rag_tpu_torch.training.token_dataset import TokenBatch

from test_torch_encoder_sp import EXTRACTOR, MODERNBERT, _jax_sharded, _threshold_in_gap
from test_torch_parallel_training import F32_RTOL, TC, UPDATE_RTOL, _update_close, _with_biases

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

REPO = Path(__file__).resolve().parent.parent
#: layout: (ranks, SP devices a rank, TP (dp, tp), TP devices a rank)
LAYOUTS = {"2ranks": (2, 1, (1, 2), 1), "4ranks": (4, 1, (2, 2), 1), "2x2": (2, 2, (4, 2), 4)}
#: The demo's step-3 config (`scripts/dcn_two_process_demo.py`).
DEMO = dict(num_heads=2, intermediate_size=64)
HEADS = ("token", "sentence")
SP_ATOL = 5e-4
SP_GRAD_RTOL = 1e-6
QUESTION = "what is noteworthy?"
CONTEXT = " ".join(f"word{i} noteworthy item{i}." for i in range(40))
EXTRACT = dict(max_length=512, doc_stride=16, min_span_chars=10, merge_gap_chars=5)


def _sp_rows():
    rng = np.random.default_rng(13)
    ids = rng.integers(3, 128, size=(2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[1, 40:] = 0
    return ids * mask, mask


def _batches(head: str, seed: int = 4) -> list:
    """Two 8-row ragged batches of the demo's shapes (S=32, 4 sentences a
    row), dp rows with different live-label counts."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        lengths = rng.integers(10, 33, size=8)
        lengths[0] = 32
        mask = (np.arange(32)[None] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(3, 128, size=(8, 32)).astype(np.int32) * mask
        if head == "token":
            label_mask = mask.copy()
            label_mask[:, :4] = 0
            labels = rng.integers(0, 2, size=(8, 32)).astype(np.int32) * label_mask
            out.append(TokenBatch(input_ids=ids, attention_mask=mask, labels=labels, label_mask=label_mask))
            continue
        starts = np.arange(4) * 2 + 1
        boundaries = np.stack([np.stack([starts, starts + 2], 1)] * 8).astype(np.int32)
        sentences = rng.integers(1, 5, size=8)
        sentence_mask = (np.arange(4)[None] < sentences[:, None]).astype(np.int32)
        labels = rng.integers(0, 2, size=(8, 4)).astype(np.int32) * sentence_mask
        out.append(EncodedBatch(input_ids=ids, attention_mask=mask, boundaries=boundaries,
                                sentence_mask=sentence_mask, labels=labels))
    return out


HEAD_SETUP = {
    # head: (JAX init, JAX loss, port class, port loss, label mask)
    "token": (jax_init_highlighter, jax_model.token_loss, HighlighterModel, port_model.token_loss, "label_mask"),
    "sentence": (jax_model.init_qa_model_params, jax_model.sentence_loss, port_model.QAModel,
                 port_model.sentence_loss, "sentence_mask"),
}


def _jax_step(head: str, params, batch, tmp_path):
    jax_config = jax_tiny_config(**DEMO)
    _, jax_loss, *_ = HEAD_SETUP[head]
    mesh = jax_make_mesh(dp=4, tp=2)
    jt = jax_trainer.Trainer(params, jax_config, JaxTrainingConfig(**TC), str(tmp_path / f"jax_{head}"),
                             mesh=mesh, loss_fn=jax_loss, total_steps=8)
    new, _, value, _ = jax_trainer.train_step(
        jt.params, jt.opt_state, jax_trainer._batch_to_device(batch, mesh), jax_config, jt.optimizer, jax_loss
    )
    return params_from_jax(jax.tree.map(np.asarray, new)), float(value)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The workers' inputs (``inputs.pt``) and the JAX references."""
    tmp = tmp_path_factory.mktemp("tp_sp_inputs")
    sp_params = jax_init_encoder(jax.random.PRNGKey(1), jax_tiny_config(**MODERNBERT))
    hl_params = jax_init_highlighter(jax.random.PRNGKey(5), jax_tiny_config(**EXTRACTOR))
    ids, mask = _sp_rows()
    probe = np.random.default_rng(1).normal(size=(2, 64, 32)).astype(np.float32)
    data = dict(
        sp_state=params_from_jax(jax.tree.map(np.asarray, sp_params)), ids=torch.from_numpy(ids),
        mask=torch.from_numpy(mask), probe=torch.from_numpy(probe),
        hl_state=params_from_jax(jax.tree.map(np.asarray, hl_params)),
    )
    refs = dict(sp_params=sp_params, hl_params=hl_params, ids=ids, mask=mask)
    for head in HEADS:
        jax_init, *_ = HEAD_SETUP[head]
        params = _with_biases(jax_init(jax.random.PRNGKey(3), jax_tiny_config(**DEMO)), 3)
        batches = _batches(head)
        data[f"{head}_state"] = params_from_jax(jax.tree.map(np.asarray, params))
        data[f"{head}_batches"] = batches
        refs[head] = dict(params=params, batches=batches, state=data[f"{head}_state"])
        refs[head]["jax_after"], refs[head]["jax_loss"] = _jax_step(head, params, batches[0], tmp)
    jax_sp = JaxExtractor(params=hl_params, config=jax_tiny_config(**EXTRACTOR), tokenizer=JaxTokenizer(vocab_size=128),
                          sp_mesh=jax_make_mesh(dp=1, tp=4, devices=jax.devices()[:4]), **EXTRACT)
    jax_sp.threshold = _threshold_in_gap(jax_sp, QUESTION, CONTEXT)
    data["threshold"] = refs["threshold"] = jax_sp.threshold
    refs["jax_spans"] = jax_sp.process(QUESTION, CONTEXT)
    assert refs["jax_spans"]
    torch.save(data, tmp / "inputs.pt")
    return tmp / "inputs.pt", refs


#: One rank of a layout's group: SP forward / backward / extraction, the TP
#: steps of both heads, then (by layout) the misfit layouts or the planted
#: faults; with its group gone, the one-process references.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch
    from verbatim_rag_tpu_torch.models import Encoder, ModelSpanExtractor, encoder_forward_sp
    from verbatim_rag_tpu_torch.models.config import TrainingConfig, tiny_test_config
    from verbatim_rag_tpu_torch.models.highlighter import HighlighterModel
    from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
    from verbatim_rag_tpu_torch.ops.ring_attention import shard_sequence
    from verbatim_rag_tpu_torch.parallel import distributed, exchange, make_mesh
    from verbatim_rag_tpu_torch.training import model as port_model
    from verbatim_rag_tpu_torch.training import trainer as port_trainer

    out_path, in_path, cfg = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    data = torch.load(in_path, weights_only=False)
    heads = {"token": (HighlighterModel, port_model.token_loss), "sentence": (port_model.QAModel, port_model.sentence_loss)}

    def sp(mesh):
        model = Encoder(tiny_test_config(**cfg["modernbert"]))
        model.load_state_dict(data["sp_state"])
        ids, mask = shard_sequence(data["ids"], mesh), shard_sequence(data["mask"], mesh)
        line = mesh.line("tp")
        hidden = encoder_forward_sp(model, ids, mask, mesh)
        width = hidden[0].shape[1]
        cols = slice(line.first * width, (line.first + line.count) * width)
        live = data["mask"][:, cols].float()[..., None]
        (torch.cat(hidden, dim=1) * data["probe"][:, cols] * live).sum().backward()
        grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
        return dict(first=line.first, hidden=torch.cat(hidden, dim=1).detach(), grads=grads)

    def extract(mesh):
        ext = ModelSpanExtractor(params=data["hl_state"], config=tiny_test_config(**cfg["extractor"]),
                                 tokenizer=HashTokenizer(vocab_size=128), sp_mesh=mesh, threshold=data["threshold"],
                                 device="cpu", **cfg["extract"])
        return ext.process(cfg["question"], cfg["context"])

    def tp(mesh, head, steps=2, keep=True):
        cls, loss_fn = heads[head]
        model = cls(tiny_test_config(**cfg["demo"]))
        model.load_state_dict(data[f"{head}_state"])
        trainer = port_trainer.Trainer(model, model.config, TrainingConfig(**cfg["tc"]), mesh=mesh, loss_fn=loss_fn,
                                       total_steps=8)
        out = {}
        for i, batch in enumerate(data[f"{head}_batches"][:steps]):
            loss, _ = port_trainer.train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), loss_fn)
            out[f"loss{i + 1}"], out[f"norm{i + 1}"] = float(loss), trainer.optimizer.grad_norm
            if i == 0:
                out["after1"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        sharded = trainer.model
        if keep:
            out["leaves"] = {f"{name}@{d},{t}": leaf.detach().clone() for d, t in mesh.local_positions()
                             for name, leaf in sharded.leaves[d][t].items()}
            out["unequal_local"] = sharded.unequal_copies()
            ckpt = os.path.join(cfg["tmp"], f"ckpt_{head}")
            trainer.save_checkpoint(ckpt)
            out["gathered"] = {k: v.clone() for k, v in sharded.state_dict().items()}
        return out

    assert distributed.initialize() is True
    rank, world = distributed.process_index(), distributed.process_count()
    out = dict(rank=rank, backend=str(torch.distributed.get_backend()))
    sp_mesh = distributed.global_mesh(dp=1, tp=world * cfg["sp_per"], devices=["cpu"] * cfg["sp_per"])
    out["sp"] = sp(sp_mesh)
    out["spans"] = extract(sp_mesh)
    out["handoffs"] = exchange.handoffs
    tp_mesh = distributed.global_mesh(*cfg["tp_layout"], devices=["cpu"] * cfg["tp_per"])
    out["tp_ranks"] = tp_mesh.ranks
    for head in cfg["heads"]:
        out[head] = tp(tp_mesh, head)
    if cfg["misfit"]:
        messages = []
        for dp, devices in ((world + 1, ["cpu"]), (None, ["cpu"] * (rank + 1))):
            try:
                distributed.global_mesh(dp=dp, tp=1, devices=devices)
                messages.append("")
            except ValueError as err:
                messages.append(str(err))
        try:  # no devices named: every visible card, and the CPU machine has none
            distributed.global_mesh(dp=world, tp=1)
            messages.append("")
        except RuntimeError as err:
            messages.append(str(err))
        out["misfit"] = messages
    if cfg["faults"]:
        kept = exchange.ring_shift

        def backward_ring(x, line, device):
            (y,) = exchange.exchange([(x, line.prev_rank)], [(x.shape, x.dtype, line.next_rank, device)], line.group)
            return y

        exchange.ring_shift = backward_ring
        try:
            out["fault_ring"] = sp(sp_mesh)["hidden"]
        finally:
            exchange.ring_shift = kept
        kept = port_model.loss_group
        port_model.loss_group = lambda model: distributed.world()  # the loss's counts over all ranks
        try:
            out["fault_world_counts"] = tp(tp_mesh, "token", steps=1, keep=False)["loss1"]
        finally:
            port_model.loss_group = kept
    torch.distributed.destroy_process_group()
    assert distributed.process_count() == 1
    n_sp = world * cfg["sp_per"]
    ref = sp(make_mesh(dp=1, tp=n_sp, devices=["cpu"] * n_sp))
    out["sp_ref"] = dict(hidden=ref["hidden"], grads=ref["grads"])
    dp, tp_ = cfg["tp_layout"]
    one = make_mesh(dp=dp, tp=tp_, devices=["cpu"] * (dp * tp_))
    out["tp_ref_loss1"] = tp(one, "token", steps=1, keep=False)["loss1"]
    torch.save(out, out_path)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp: Path, in_path: Path, layout: str) -> list:
    """The layout's group, started: one process a rank."""
    n_ranks, sp_per, tp_layout, tp_per = LAYOUTS[layout]
    cfg = dict(modernbert=MODERNBERT, extractor=EXTRACTOR, extract=EXTRACT, question=QUESTION, context=CONTEXT,
               demo=DEMO, tc=TC, heads=list(HEADS), sp_per=sp_per, tp_layout=list(tp_layout), tp_per=tp_per,
               misfit=layout == "2ranks", faults=layout == "4ranks", tmp=str(tmp))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n_ranks), OMP_NUM_THREADS="1")
    return [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / f"rank{rank}.pt"), str(in_path), json.dumps(cfg)],
            cwd=REPO, env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(n_ranks)
    ]


@pytest.fixture(scope="module")
def groups(inputs, tmp_path_factory):
    """Every layout's group, run side by side (150 s each at most): layout →
    (each rank's outputs, the group's directory)."""
    in_path, _ = inputs
    dirs = {layout: tmp_path_factory.mktemp(layout) for layout in LAYOUTS}
    procs = {layout: _start(dirs[layout], in_path, layout) for layout in LAYOUTS}
    try:
        outputs = {layout: [p.communicate(timeout=150) for p in ps] for layout, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    for layout, ps in procs.items():
        assert [p.returncode for p in ps] == [0] * len(ps), (layout, [err[-3000:] for _, err in outputs[layout]])
    return {
        layout: ([torch.load(dirs[layout] / f"rank{r}.pt", weights_only=False) for r in range(len(ps))], dirs[layout])
        for layout, ps in procs.items()
    }


# -- (a) sequence parallelism ----------------------------------------------------------


def _sp_line(ranks: list[dict]) -> torch.Tensor:
    return torch.cat([r["sp"]["hidden"] for r in sorted(ranks, key=lambda r: r["sp"]["first"])], dim=1)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sp_forward_is_the_one_process_ring_bit_for_bit(groups, layout):
    ranks, _ = groups[layout]
    ref = ranks[0]["sp_ref"]["hidden"]
    for r in ranks:
        assert torch.equal(r["sp_ref"]["hidden"], ref)
        assert r["handoffs"] > 0 and r["backend"] == "gloo"
    assert torch.equal(_sp_line(ranks), ref)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sp_forward_matches_jax(groups, inputs, layout):
    ranks, _ = groups[layout]
    _, refs = inputs
    n = len(ranks) * LAYOUTS[layout][1]
    jax_mesh = jax_make_mesh(dp=1, tp=n, devices=jax.devices()[:n])
    want = np.asarray(jax_forward_sp(refs["sp_params"], jax_tiny_config(**MODERNBERT),
                                     *_jax_sharded(jax_mesh, refs["ids"], refs["mask"]), jax_mesh))
    np.testing.assert_allclose(_sp_line(ranks).numpy(), want, rtol=SP_ATOL, atol=SP_ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sp_gradients_summed_over_ranks_match_one_process(groups, layout):
    ranks, _ = groups[layout]
    want = ranks[0]["sp_ref"]["grads"]
    assert all(set(r["sp"]["grads"]) == set(want) for r in ranks) and "embeddings.word" in want
    got = {k: sum(r["sp"]["grads"][k] for r in ranks) for k in want}
    errors = {k: float((got[k] - want[k]).norm() / want[k].norm()) for k in want}
    assert max(errors.values()) <= SP_GRAD_RTOL, errors


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sp_extractor_spans_equal_jax_on_every_rank(groups, inputs, layout):
    ranks, _ = groups[layout]
    _, refs = inputs
    assert all(r["spans"] == refs["jax_spans"] for r in ranks)


# -- (b) tensor parallelism ------------------------------------------------------------


def _single_step(head: str, refs: dict):
    _, _, cls, loss_fn, _ = HEAD_SETUP[head]
    model = cls(tiny_test_config(**DEMO))
    model.load_state_dict(refs[head]["state"])
    optimizer = port_trainer.make_optimizer(TrainingConfig(**TC), model.parameters(), total_steps=8)
    batch = port_trainer.batch_to_device(refs[head]["batches"][0], "cpu")
    loss, _ = port_trainer.train_step(model, optimizer, batch, loss_fn)
    return float(loss), optimizer.grad_norm, model.state_dict()


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_step_matches_jax_and_single_device(groups, inputs, layout, head):
    ranks, _ = groups[layout]
    _, refs = inputs
    rows = ranks[0]["tp_ranks"]
    assert any(len(set(row)) > 1 for row in rows) == (layout != "2x2")  # tp across ranks, or dp across
    assert len({r for row in rows for r in row}) == len(ranks)
    single_loss, single_norm, single_state = _single_step(head, refs)
    got = ranks[0][head]
    np.testing.assert_allclose(got["loss1"], refs[head]["jax_loss"], rtol=F32_RTOL)
    np.testing.assert_allclose(got["loss1"], single_loss, rtol=F32_RTOL)
    assert got["norm1"] > TC["max_grad_norm"]  # clipping acted
    np.testing.assert_allclose(got["norm1"], single_norm, rtol=F32_RTOL)
    for r in ranks:
        assert [r[head][k] for k in ("loss1", "norm1", "loss2", "norm2")] == [
            got[k] for k in ("loss1", "norm1", "loss2", "norm2")]
    _update_close(got["after1"], refs[head]["state"], refs[head]["jax_after"], "jax")
    _update_close(got["after1"], refs[head]["state"], single_state, "single device")
    if LAYOUTS[layout][2][0] == 1:  # one tp row: the loss is the one-process mesh's, bit for bit
        assert ranks[0]["tp_ref_loss1"] == ranks[0]["token"]["loss1"]


#: The tp-sliced parameters (`parallel.mesh.encoder_param_specs`): a copy a
#: (d, t) for every d; every other parameter a copy at every position.
SLICED = (".attn.q.kernel", ".attn.k.kernel", ".attn.v.kernel", ".attn.o.kernel", ".mlp.wi.", ".mlp.wo.kernel")


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_copies_bit_equal_across_ranks_after_two_steps(groups, layout, head):
    ranks, _ = groups[layout]
    copies: dict[tuple[str, str], list[torch.Tensor]] = {}
    for r in ranks:
        assert r[head]["unequal_local"] == []
        for key, value in r[head]["leaves"].items():
            name, position = key.split("@")
            t = position.split(",")[1] if any(s in f".{name}" for s in SLICED) else "all"
            copies.setdefault((name, t), []).append(value)
    assert len(copies) > 10
    dp, tp = LAYOUTS[layout][2]
    for (name, t), group in copies.items():
        assert len(group) == (dp if t != "all" else dp * tp), (name, t)
        assert all(torch.equal(c, group[0]) for c in group), (name, t)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_checkpoint_loads_in_jax(groups, layout, head):
    ranks, directory = groups[layout]
    jax_init, *_ = HEAD_SETUP[head]
    template = jax_init(jax.random.PRNGKey(0), jax_tiny_config(**DEMO))
    path = directory / f"ckpt_{head}"
    loaded = params_from_jax(jax.tree.map(np.asarray, jax_trainer.Trainer.load_checkpoint(str(path), template)))
    gathered = ranks[0][head]["gathered"]
    assert set(loaded) == set(gathered)
    for name, value in gathered.items():
        assert torch.equal(loaded[name], value), name
    assert json.loads((path / "verbatim_config.json").read_text())["head"] == head
    # the last rank's q slice (the heads of its t) sits in the gathered tree at its columns
    key, leaf = next((k, v) for k, v in ranks[-1][head]["leaves"].items() if k.startswith("layers.0.attn.q.kernel@"))
    t = int(key.split(",")[1])
    width = leaf.shape[1]
    assert torch.equal(gathered["layers.0.attn.q.kernel"][:, t * width : (t + 1) * width], leaf)


# -- (c) planted faults and misfit layouts ---------------------------------------------


def test_a_ring_rotated_backwards_at_the_rank_boundary_fails(groups):
    """K/V handed j → j − 1 between ranks: the forward differs from the
    one-process ring (the check of (a) fails)."""
    ranks, _ = groups["4ranks"]
    ref = ranks[0]["sp_ref"]["hidden"]
    line = torch.cat([r["fault_ring"] for r in ranks], dim=1)
    assert not np.allclose(line.numpy(), ref.numpy(), rtol=SP_ATOL, atol=SP_ATOL)


def test_loss_counts_summed_over_the_world_fail(groups, inputs):
    """Counts summed over all four ranks count each dp row twice (two tp
    ranks a row): step 1's loss misses JAX's by half."""
    ranks, _ = groups["4ranks"]
    _, refs = inputs
    for r in ranks:
        assert not np.isclose(r["fault_world_counts"], refs["token"]["jax_loss"], rtol=F32_RTOL)
        np.testing.assert_allclose(r["fault_world_counts"], refs["token"]["jax_loss"] / 2, rtol=F32_RTOL)


def test_a_misfit_mesh_raises_on_every_rank(groups):
    """dp·tp past the ranks' devices, and ranks passing unequal devices:
    every rank raises (none is left waiting in a collective); with no
    devices named the mesh is the visible cards', and without a card every
    rank raises before any collective."""
    ranks, _ = groups["2ranks"]
    for r in ranks:
        too_many, unequal, no_card = r["misfit"]
        assert "dp·tp must be the sum of the ranks' devices" in too_many, too_many
        assert "every rank must pass as many devices" in unequal, unequal
        assert "no CUDA device is available" in no_card, no_card
