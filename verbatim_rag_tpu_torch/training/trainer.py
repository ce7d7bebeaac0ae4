"""Trainer: AdamW with global-norm clipping and a warmup-cosine schedule, dev
F1 evaluation and ``.npz`` checkpoints (port of
`verbatim_rag_tpu/training/trainer.py`).

The optimizer is the JAX package's optax chain, ``clip_by_global_norm``
then ``adamw(warmup_cosine_decay_schedule(0, lr, warmup, total))``, on
torch parameters (:class:`Optimizer`):

- clipping divides by the global norm itself (``torch.nn.utils.clip_grad_norm_``
  would divide by norm + 1e-6), and only when the norm reaches the limit;
- AdamW (``torch.optim.AdamW``, fused on CUDA) takes eps outside the square
  root and decays every parameter, as optax's ``adamw`` does; a parameter
  the loss does not reach gets a zero gradient, so it is decayed too;
- the rate is the schedule at the update count before the update, so with
  warmup the first update has rate 0.

On a ``[dp, tp]`` mesh (``Trainer(mesh=...)``, JAX's sharded train step)
the model is placed by `parallel.mesh.shard_params` (each mesh position's
slices and replicated copies resident on its own device, the unsharded
module on the host) and each batch split by rows over ``dp``
(:func:`batch_to_mesh`); the loss is the global masked mean over the rows
(`model.masked_loss`). After the backward, :func:`sync_grads` sums each
logical tensor's gradient over its copies (over ``dp`` for a tp slice, over
every position for a replicated parameter) and, under a process group of
more than one process (`parallel.distributed`), over the group, and writes
the sum to every copy. Clipping takes the global norm of the logical set
(each tensor once) and AdamW updates every copy alike, so the copies stay
bit-equal. The unsharded tree is gathered for a checkpoint and at the end of
:meth:`Trainer.train`; only rank 0 writes checkpoints.

On a mesh across processes (`parallel.distributed.global_mesh`) a rank
holds its own positions, takes the global batch and feeds its dp rows; a tp
row across ranks runs the encoder's root design (`parallel.exchange.TPRow`),
the loss's counts and value sum over the rank's dp column
(`model.loss_group`), a group's copies sum over the ranks that hold them
and the global norm over the whole mesh.

Checkpoints are the JAX package's layout (`models/hf_convert.py`), so either
package loads the other's; orbax checkpoints are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from verbatim_rag_tpu_torch.models.config import EncoderConfig, TrainingConfig
from verbatim_rag_tpu_torch.models.hf_convert import load_params_npz, save_params_npz
from verbatim_rag_tpu_torch.parallel import distributed
from verbatim_rag_tpu_torch.parallel.mesh import ShardedModel, data_sharding, shard_params

from .dataset import EncodedBatch
from .model import loss_group, sentence_loss

logger = logging.getLogger(__name__)


def warmup_cosine_schedule(tc: TrainingConfig, total_steps: int = 10_000):
    """The learning rate at an update count: ``optax.warmup_cosine_decay_schedule(
    0, lr, warmup, max(total, warmup + 1))`` (end value 0), or the constant
    rate without warmup."""
    lr, warmup = tc.learning_rate, tc.warmup_steps
    decay = max(total_steps, warmup + 1) - warmup

    def rate(count: int) -> float:
        if not warmup:
            return lr
        if count < warmup:
            return lr * count / warmup
        frac = min(count - warmup, decay) / decay
        return lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return rate


def by_device(tensors: Iterable[torch.Tensor]) -> dict[torch.device, list[torch.Tensor]]:
    """Tensors grouped by device, each group in the given order (a
    ``torch._foreach_*`` call takes the tensors of one device)."""
    groups: dict[torch.device, list[torch.Tensor]] = {}
    for x in tensors:
        groups.setdefault(x.device, []).append(x)
    return groups


class Optimizer:
    """Global-norm clipping, then one AdamW update at the schedule's rate.

    ``norm_params`` (default: every parameter) are the tensors the global
    norm counts: on a mesh each logical tensor once, while clipping and
    AdamW take every copy (`parallel.mesh.ShardedModel.logical_parameters`).
    With ``norm_group`` (a mesh across processes) each rank passes the
    logical tensors it owns and the squares are summed over the group.
    """

    def __init__(
        self, params: Iterable[torch.nn.Parameter], tc: TrainingConfig, total_steps: int,
        norm_params: Iterable[torch.Tensor] | None = None, norm_group=None,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.norm_params = self.params if norm_params is None else [p for p in norm_params if p.requires_grad]
        self.norm_group = norm_group
        self.max_grad_norm = tc.max_grad_norm
        self.schedule = warmup_cosine_schedule(tc, total_steps)
        self.adamw = torch.optim.AdamW(
            self.params,
            lr=self.schedule(0),
            betas=(tc.adam_b1, tc.adam_b2),
            eps=tc.adam_eps,
            weight_decay=tc.weight_decay,
            fused=True if all(p.is_cuda for p in self.params) else None,
        )
        #: updates made so far (optax's count)
        self.count = 0
        #: global norm of the last step's gradients, before clipping
        self.grad_norm = float("nan")
        #: True while an update is being applied: an exception raised then
        #: leaves the parameters half updated
        self.stepping = False

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def global_norm(self) -> torch.Tensor:
        """The global norm of the ``norm_params``' gradients (a missing one
        counts as 0), on the first one's device: the per-tensor norms of
        each device, then the norm of them all. With a ``norm_group`` the
        ranks' sums of squares (float64) are summed over it first, so
        every rank gets the same norm."""
        grads = [p.grad for p in self.norm_params if p.grad is not None]
        home = grads[0].device if grads else self.params[0].device
        norms = [n.to(home) for group in by_device(grads).values() for n in torch._foreach_norm(group)]
        if self.norm_group is None:
            return torch.linalg.vector_norm(torch.stack(norms))
        squares = torch.stack(norms).double().square().sum() if norms else torch.zeros((), dtype=torch.float64)
        squares = distributed.all_reduce_(squares.cpu(), self.norm_group)
        return squares.sqrt().float().to(home)

    def step(self) -> float:
        """Clip, update, count; returns the global gradient norm."""
        self.stepping = True
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = self.global_norm()
        self.grad_norm = float(norm)
        if not self.grad_norm < self.max_grad_norm:  # as optax: NaN clips too
            for device, group in by_device(grads).items():
                torch._foreach_div_(group, norm.to(device))
                torch._foreach_mul_(group, self.max_grad_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        self.stepping = False
        return self.grad_norm


def make_optimizer(
    tc: TrainingConfig, params: Iterable[torch.nn.Parameter], total_steps: int = 10_000,
    norm_params: Iterable[torch.Tensor] | None = None, norm_group=None,
) -> Optimizer:
    return Optimizer(params, tc, total_steps, norm_params, norm_group)


def sync_grads(model, optimizer: Optimizer) -> None:
    """One backward's gradients made whole before clipping: on a mesh each
    logical tensor's copies summed and the sum written to every copy
    (`parallel.mesh.ShardedModel.sync_grads`, over the ranks of a mesh that
    spans processes), and on a mesh of this process or a plain model under
    a process group summed over the group."""
    if isinstance(model, ShardedModel):
        model.sync_grads(None if model.mesh.spans_processes else distributed.all_reduce_grads)
    else:
        distributed.all_reduce_grads(optimizer.params)


def train_step(model, optimizer: Optimizer, batch, loss_fn=sentence_loss):
    """One optimization step in place: loss → grads (:func:`sync_grads`) →
    clipped AdamW update. ``batch`` is a dict of tensors, or for a
    `parallel.mesh.ShardedModel` its rows' dicts.

    :return: (loss, aux) as tensors; the loss summed over the process group.
    """
    optimizer.zero_grad()
    loss, aux = loss_fn(model, batch)
    loss.backward()
    sync_grads(model, optimizer)
    optimizer.step()
    return _group_loss(loss, model), {k: v.detach() for k, v in aux.items()}


def eval_step(model, batch, loss_fn=sentence_loss):
    with torch.no_grad():
        loss, aux = loss_fn(model, batch)
    return _group_loss(loss, model), aux


def _group_loss(loss: torch.Tensor, model) -> torch.Tensor:
    """The global loss: each process's loss is its share (`model.masked_loss`),
    summed over `model.loss_group`."""
    return distributed.all_reduce_sum({"loss": loss.detach()}, loss_group(model))["loss"].to(loss.device)


def batch_to_device(batch, device) -> dict[str, torch.Tensor]:
    """Any dataclass batch (EncodedBatch, TokenBatch, ...) → dict of tensors."""
    return {
        f.name: torch.from_numpy(np.asarray(getattr(batch, f.name))).to(device)
        for f in dataclasses.fields(batch)
        if getattr(batch, f.name) is not None
    }


def batch_to_mesh(batch, mesh) -> list[dict[str, torch.Tensor]]:
    """A dataclass batch split by rows over the mesh's ``dp`` axis
    (`parallel.mesh.data_sharding`, JAX's ``P("dp")``): one dict of tensors
    per data row (on a mesh that spans processes, ``batch`` is the global
    batch and the dicts are this rank's dp rows'). Raises ``ValueError``
    when the rows do not divide."""
    fields = batch_to_device(batch, "cpu")
    shards = {name: data_sharding(value, mesh) for name, value in fields.items()}
    return [{name: parts[i] for name, parts in shards.items()} for i in range(len(mesh.local_rows()))]


def metrics_from_counts(counts: dict[str, float]) -> dict[str, float]:
    tp, fp, fn = counts.get("tp", 0.0), counts.get("fp", 0.0), counts.get("fn", 0.0)
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    accuracy = (
        counts.get("n_correct", 0.0) / counts["n_sentences"]
        if counts.get("n_sentences")
        else 0.0
    )
    return {"precision": precision, "recall": recall, "f1": f1, "accuracy": accuracy}


class Trainer:
    """Epoch loop with dev evaluation and best-F1 checkpointing.

    ``model`` (a `QAModel` or `HighlighterModel`) is trained in place on its
    own device, or with ``mesh`` on a ``[dp, tp]`` mesh (:attr:`model` is
    then its `parallel.mesh.ShardedModel`: the mesh positions' leaves are
    updated, and ``model`` itself, on the host, receives the gathered tree
    for each checkpoint and at the end of :meth:`train`). Each optimization step is logged in
    :attr:`steps` (loss, global gradient norm, host seconds); a batch that
    runs out of device memory before the update is skipped with its
    gradients dropped and counted in :attr:`oom_skips`.
    """

    def __init__(
        self,
        model,
        encoder_config: EncoderConfig,
        training_config: TrainingConfig | None = None,
        output_dir: str = "./qa_model_out",
        mesh=None,
        loss_fn=sentence_loss,
        total_steps: int | None = None,
        tokenizer=None,
    ):
        self.mesh = mesh
        self.model = model if mesh is None else shard_params(model, mesh)
        self.encoder_config = encoder_config
        self.tc = training_config or TrainingConfig()
        self.output_dir = output_dir
        self.loss_fn = loss_fn
        #: recorded in checkpoints so the serving extractor can rebuild the
        #: same tokenizer (None → hash tokenizer at the config vocab)
        self.tokenizer = tokenizer
        # Size the (warmup+cosine) schedule to the actual run.
        self.optimizer = make_optimizer(
            self.tc, self.model.parameters(), total_steps or 10_000,
            None if mesh is None else self.model.logical_parameters(),
            None if mesh is None else self.model.process_group(),
        )
        self.best_f1 = -1.0
        self.history: list[dict] = []
        self.steps: list[dict] = []
        self.oom_skips = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def batch_to_device(self, batch):
        """A dataclass batch on the model's device, or split over the mesh."""
        return batch_to_device(batch, self.device) if self.mesh is None else batch_to_mesh(batch, self.mesh)

    def train(
        self,
        train_batches: Iterator[EncodedBatch] | list[EncodedBatch],
        dev_batches: list[EncodedBatch] | None = None,
        num_epochs: int | None = None,
        make_train_iter=None,
    ) -> dict:
        """Run the full loop. Pass ``make_train_iter`` (epoch → iterator) for
        re-shuffled epochs; otherwise the same batch list is reused."""
        epochs = num_epochs or self.tc.num_epochs
        if make_train_iter is None:
            cached = list(train_batches)
            make_train_iter = lambda epoch: iter(cached)  # noqa: E731

        for epoch in range(epochs):
            t0 = time.time()
            losses = []
            for batch in make_train_iter(epoch):
                device_batch = self.batch_to_device(batch)
                started = time.perf_counter()
                try:
                    loss, _aux = train_step(self.model, self.optimizer, device_batch, self.loss_fn)
                    loss = float(loss)
                except torch.cuda.OutOfMemoryError as exc:
                    if self.optimizer.stepping:
                        raise RuntimeError(
                            "Batch ran out of memory inside the parameter update — "
                            "training state is unrecoverable. Reduce batch size / "
                            "sequence length, or resume from the last checkpoint."
                        ) from exc
                    self.optimizer.zero_grad()
                    self.oom_skips += 1
                    logger.warning("Skipping batch after OOM: %s", str(exc)[:200])
                    continue
                losses.append(loss)
                self.steps.append(
                    dict(
                        loss=loss,
                        grad_norm=self.optimizer.grad_norm,
                        seconds=time.perf_counter() - started,
                    )
                )
            record = {
                "epoch": epoch,
                "train_loss": float(np.mean(losses)) if losses else float("nan"),
                "epoch_seconds": time.time() - t0,
            }
            if dev_batches:
                record.update({f"dev_{k}": v for k, v in self.evaluate(dev_batches).items()})
                if record["dev_f1"] > self.best_f1:
                    self.best_f1 = record["dev_f1"]
                    self.save_checkpoint(os.path.join(self.output_dir, "best"))
            self.history.append(record)
            logger.info("epoch %d: %s", epoch, record)

        if self.mesh is not None:
            self.model.gather()
        self.save_checkpoint(os.path.join(self.output_dir, "final"))
        if distributed.process_index() == 0:
            with open(os.path.join(self.output_dir, "metrics.json"), "w") as f:
                json.dump({"history": self.history, "best_f1": self.best_f1}, f, indent=2)
        return {"history": self.history, "best_f1": self.best_f1}

    def evaluate(self, batches: list[EncodedBatch]) -> dict[str, float]:
        totals: dict[str, float] = {}
        losses = []
        for batch in batches:
            loss, aux = eval_step(self.model, self.batch_to_device(batch), self.loss_fn)
            losses.append(float(loss))
            for key, value in aux.items():
                totals[key] = totals.get(key, 0.0) + float(value)
        metrics = metrics_from_counts(totals)
        metrics["loss"] = float(np.mean(losses)) if losses else float("nan")
        return metrics

    # -- checkpointing -----------------------------------------------------------

    def save_checkpoint(self, path: str, format: str = "npz") -> None:
        """Persist the parameters as ``params.npz`` (the JAX package's tree
        layout) beside ``verbatim_config.json``: the whole unsharded tree,
        also after training on a mesh (gathered from the positions' leaves,
        on a mesh across processes by every rank into rank 0's); under a
        process group, rank 0 writes."""
        if format != "npz":
            raise NotImplementedError(f"checkpoint format {format!r} is not ported (npz only)")
        state = self.model.state_dict()
        if distributed.process_index() != 0:
            return
        os.makedirs(path, exist_ok=True)
        save_params_npz(state, path)
        meta = {
            "format": "verbatim-native",
            # Head kind comes from the parameters, as in the JAX package.
            "head": "sentence" if "sentence_classifier.kernel" in state else "token",
            "encoder_config": dataclasses.asdict(self.encoder_config),
            "tokenizer": self.tokenizer.describe() if hasattr(self.tokenizer, "describe") else None,
        }
        with open(os.path.join(path, "verbatim_config.json"), "w") as f:
            json.dump(meta, f, indent=1)

    @staticmethod
    def load_checkpoint(path: str, model):
        """Load the parameters saved by `save_checkpoint` (of either package)
        into ``model`` in place; every parameter of the model must be there."""
        state = load_params_npz(path)
        missing = [key for key in model.state_dict() if key not in state]
        if missing:
            raise KeyError(f"{path}: checkpoint lacks {missing[:5]}")
        model.load_state_dict({key: state[key] for key in model.state_dict()})
        return model
