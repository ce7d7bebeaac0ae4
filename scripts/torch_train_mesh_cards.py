"""Training on a mesh of distinct NVIDIA cards, and across processes over NCCL.

    python3 scripts/torch_train_mesh_cards.py [--seed 0]

Needs four cards: without them it exits with code 2 and prints no result.
It prints the cards' name and power limit, then one JSON line a part:

- ``cards``: one process, `Trainer(mesh=make_mesh(dp=2, tp=2))` over the four
  cards (shard (d, t) on card 2d + t, so activations, tp partial sums and the
  parameters' replicas cross cards), ModernBERT-base at full width with
  `chip_smoke.py`'s train batches (batch 8, S=4096); step 1 held to the
  single-device step on card 0 on the same weights and batch with
  `chip_smoke.py`'s limits (loss, every gradient before clipping, every
  updated parameter), steps 2-3 timed, 88 launches of each flash kernel a
  step, peak memory per card.
- ``processes``: four processes, one card each, joined by
  `parallel.distributed.initialize` (NCCL over the loopback interface), each
  a 1 × 1 mesh on its card fed its `process_local_batch_slice` of the same
  batch: step 1's gradients (summed over the group) and updated parameters
  on every rank equal to each other and held, with the same limits, to one
  process's dp = 4 step on card 0 (a ``[cuda:0] * 4`` mesh).

Any check that fails exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CARDS = 4


def batches_and_config(seed: int):
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import HashTokenizer, modernbert_base_config
    from verbatim_rag_tpu_torch.models.config import TrainingConfig
    from verbatim_rag_tpu_torch.training.token_dataset import TokenDatasetEncoder

    config = modernbert_base_config()
    tokenizer = HashTokenizer(vocab_size=config.vocab_size)
    examples = cs.train_examples(cs.MESH_TRAIN_STEPS * cs.TRAIN_BATCH, seed, tokenizer)
    encoder = TokenDatasetEncoder(tokenizer, max_length=cs.TRAIN_SEQ, doc_stride=128)
    batches = list(encoder.iter_batches(examples, cs.TRAIN_BATCH))
    batches[0] = cs.shards_by_live_labels(batches[0])
    tc = TrainingConfig(batch_size=cs.TRAIN_BATCH, max_seq_length=cs.TRAIN_SEQ, seed=seed)
    return config, tc, batches


def held_update(model, ref_params: dict) -> dict:
    import chip_smoke as cs

    errors = cs.tensor_errors(model.state_dict(), ref_params)
    name = max(errors, key=errors.get)
    return dict(param_worst_rel=errors[name], param_worst_tensor=name, param_of_limit=errors[name] / cs.MESH_PARAM_RTOL)


def single_step(config, tc, batch, seed: int, mesh=None):
    """Step 1 from the seeded weights on card 0, alone or on ``mesh``:
    (loss, gradients before clipping, updated parameters)."""
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import init_highlighter_params
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer

    model = init_highlighter_params(config, seed=seed, device="cuda:0")
    trainer = Trainer(model, config, tc, mesh=mesh, loss_fn=token_loss)
    loss, grads = cs.step_grads(trainer, batch, token_loss)
    trainer.optimizer.step()
    return loss, grads, {k: v.detach().clone() for k, v in model.state_dict().items()}


def synchronize() -> None:
    import torch

    for i in range(CARDS):
        torch.cuda.synchronize(i)


def run_cards(config, tc, batches, seed: int) -> dict:
    """dp=2 × tp=2 over the four cards in one process."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import init_highlighter_params
    from verbatim_rag_tpu_torch.parallel import make_mesh
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer, train_step

    ref_loss, ref_grads, ref_params = single_step(config, tc, batches[0], seed)
    torch.cuda.empty_cache()
    model = init_highlighter_params(config, seed=seed, device="cuda:0")
    mesh = make_mesh(dp=2, tp=2, devices=[torch.device("cuda", i) for i in range(CARDS)])
    trainer = Trainer(model, config, tc, mesh=mesh, loss_fn=token_loss)
    for i in range(CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    step_s, held = [], None
    layers = config.num_layers * mesh.size
    for step, batch in enumerate(batches[: cs.MESH_TRAIN_STEPS]):
        cs.reset_counts()
        t0 = time.perf_counter()
        if step == 0:
            loss, grads = cs.step_grads(trainer, batch, token_loss)
            trainer.optimizer.step()
        else:
            loss = float(train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), token_loss)[0])
        synchronize()
        step_s.append(time.perf_counter() - t0)
        counts = cs.read_counts()
        cs.require(
            counts["flash_attention"] == layers and counts["flash_bwd_dq"] == layers
            and counts["flash_bwd_dkv"] == layers,
            f"cards: step {step + 1} launches {counts}, expected {layers} of each flash kernel",
        )
        if step == 0:
            held = cs.held_to_single(loss, grads, ref_loss, ref_grads)
            held.update(held_update(model, ref_params))
            held["worst"] = max(held["worst"], held["param_of_limit"])
            cs.require(held["worst"] <= 1.0, f"cards: step 1 differs from the single-device step: {held}")
            del grads, ref_grads, ref_params
    replica_cards = sorted({key[2].index for key in trainer.model.replicas.buffers})
    cs.require(replica_cards == [1, 2, 3], f"cards: replicas on cards {replica_cards}, expected 1-3")
    median_s = float(np.median(step_s[1:]))
    return dict(
        dp=2, tp=2, cards=CARDS, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ, step_s=step_s,
        step_s_median_2_to_3=median_s, tokens_per_s=cs.TRAIN_BATCH * cs.TRAIN_SEQ / median_s,
        peak_memory_gb_per_card=[torch.cuda.max_memory_allocated(i) / 1e9 for i in range(CARDS)],
        held=held, worst_of_limit=held["worst"], replica_cards=replica_cards,
    )


def worker(rank: int, port: int, seed: int, out_dir: str) -> None:
    """One process of the group: its card, its rows, one step; writes its
    gradients (after the group's sum) and updated parameters."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import init_highlighter_params
    from verbatim_rag_tpu_torch.parallel import distributed
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.token_dataset import TokenBatch
    from verbatim_rag_tpu_torch.training.trainer import Trainer

    torch.cuda.set_device(rank)
    cs.require(distributed.initialize(f"127.0.0.1:{port}", CARDS, rank), "processes: no process group")
    cs.require("cuda:nccl" in torch.distributed.get_backend(), "processes: CUDA collectives do not run on NCCL")
    probe = torch.ones(1)
    torch.distributed.all_reduce(probe)
    cs.require(float(probe) == CARDS, "processes: a CPU collective did not run on gloo")
    config, tc, batches = batches_and_config(seed)
    rows = distributed.process_local_batch_slice(batches[0].input_ids.shape[0])
    local = TokenBatch(**{name: getattr(batches[0], name)[rows] for name in TokenBatch.__dataclass_fields__})
    model = init_highlighter_params(config, seed=seed, device=f"cuda:{rank}")
    mesh = distributed.global_mesh(dp=1, tp=1, devices=[torch.device("cuda", rank)])
    trainer = Trainer(model, config, tc, mesh=mesh, loss_fn=token_loss)
    trainer.optimizer.zero_grad()
    loss, _ = token_loss(trainer.model, trainer.batch_to_device(local))
    loss.backward()
    distributed.all_reduce_grads(trainer.optimizer.params)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    total = distributed.all_reduce_sum({"loss": loss.detach()})["loss"]
    trainer.optimizer.step()
    torch.save(
        dict(loss=float(total), grads=grads, params={k: v.detach().cpu() for k, v in model.state_dict().items()}),
        os.path.join(out_dir, f"rank{rank}.pt"),
    )
    torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(config, tc, batches, seed: int) -> dict:
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from verbatim_rag_tpu_torch.parallel import make_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        t0 = time.perf_counter()
        mp.spawn(worker, args=(free_port(), seed, out_dir), nprocs=CARDS, join=True)
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(CARDS)]
    mesh = make_mesh(dp=CARDS, tp=1, devices=[torch.device("cuda", 0)] * CARDS)
    ref_loss, ref_grads, ref_params = single_step(config, tc, batches[0], seed, mesh)
    ref_grads = {k: v.cpu() for k, v in ref_grads.items()}
    ref_params = {k: v.cpu() for k, v in ref_params.items()}
    for r in ranks[1:]:
        cs.require(
            all(torch.equal(r["params"][k], ranks[0]["params"][k]) for k in ranks[0]["params"]),
            "processes: ranks end with different parameters",
        )
    held = cs.held_to_single(ranks[0]["loss"], ranks[0]["grads"], ref_loss, ref_grads)
    errors = cs.tensor_errors(ranks[0]["params"], ref_params)
    name = max(errors, key=errors.get)
    held.update(param_worst_rel=errors[name], param_worst_tensor=name, param_of_limit=errors[name] / cs.MESH_PARAM_RTOL)
    held["worst"] = max(held["worst"], held["param_of_limit"])
    cs.require(held["worst"] <= 1.0, f"processes: the group's step differs from one dp=4 process: {held}")
    return dict(processes=CARDS, backend="nccl", group_s_with_start=group_s, ranks_equal=True, held=held,
                worst_of_limit=held["worst"])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        sys.stderr.write(f"torch_train_mesh_cards: no CUDA device or fewer than {CARDS} cards\n")
        raise SystemExit(2)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.ops import cuda_build

    card = cs.gpu_name_and_limit()
    cuda_build.build_all()
    config, tc, batches = batches_and_config(args.seed)
    cards = run_cards(config, tc, batches, args.seed)
    torch.cuda.empty_cache()
    processes = run_processes(config, tc, batches, args.seed)
    print(card)
    print(json.dumps({"cards": cards}))
    print(json.dumps({"processes": processes}))


if __name__ == "__main__":
    main()
