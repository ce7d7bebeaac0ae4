"""Training on a mesh of distinct NVIDIA cards, and across processes over NCCL.

    python3 scripts/torch_train_mesh_cards.py [--seed 0]

Needs four cards: without them it exits with code 2 and prints no result.
It prints the cards' name and power limit, then one JSON line a part:

- ``cards``: one process, `Trainer(mesh=make_mesh(dp=2, tp=2))` over the four
  cards (position (d, t) on card 2d + t holds its slices, its copies of the
  replicated parameters, their gradients and AdamW state; activations, tp
  partial sums and the gradient sync cross cards; the unsharded module stays
  on the host), ModernBERT-base at full width with `chip_smoke.py`'s train
  batches (batch 8, S=4096); step 1 held to the single-device step on card
  0 on the same weights and batch with `chip_smoke.py`'s limits (loss, every
  gradient before clipping and the global norm, every updated parameter),
  steps 2-3 timed beside the single-device steps 2-3 on card 0, 88 launches
  of each flash kernel a step, every copy bit-equal after step 3, peak
  memory and resident bytes (leaves, gradients, AdamW state) per card; no
  card may hold the whole model's AdamW state, and cards 0 and 2 (the rows'
  first positions), and cards 1 and 3, must peak within 10% of each other
  (checked after the JSON lines are printed).
- ``processes``: four processes, one card each, joined by
  `parallel.distributed.initialize` (NCCL over the loopback interface), each
  a 1 × 1 mesh on its card fed its `process_local_batch_slice` of the same
  batches: step 1's gradients (summed over the group) and updated parameters
  on every rank equal to each other and held, with the same limits, to one
  process's dp = 4 step on card 0 (a ``[cuda:0] * 4`` mesh); steps 2-3
  timed on every rank.
- ``tp_processes``: four NCCL processes, one card each, as one dp = 2 ×
  tp = 2 mesh across them (`distributed.global_mesh`: rank 2d + t holds
  position (d, t), so each tp row spans two ranks and the encoder's root
  design hands its sublayer inputs and partials between them,
  `parallel.exchange.TPRow`), each rank passing the global batches: step 1's
  loss, gradients (gathered on rank 0), global norm and updated parameters
  held to the single-device step with the same limits; loss and norm equal
  on every rank; 22 forward, dq and dk/dv launches a rank a step; every
  copy equal across ranks (by its sum) after step 3; steps 2-3 timed on
  every rank, with their hand-offs.

Any check that fails exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CARDS = 4
#: Cards 0 and 2 (each data row's first position), and cards 1 and 3, hold
#: the same leaves and activations: their peaks may differ by this share.
MAX_PEAK_SPREAD = 0.10


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


def single_step(config, tc, batches, seed: int, mesh=None):
    """Step 1 from the seeded weights on card 0, alone or on ``mesh``:
    (loss, gradients before clipping, their global norm, updated parameters,
    the seconds of each later step on ``batches[1:]``); the tensors on the
    host, so that no card's peak holds them."""
    import torch

    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import init_highlighter_params
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer, train_step

    model = init_highlighter_params(config, seed=seed, device="cuda:0")
    trainer = Trainer(model, config, tc, mesh=mesh, loss_fn=token_loss)
    loss, grads = cs.step_grads(trainer, batches[0], token_loss)
    grads = {k: v.cpu() for k, v in grads.items()}
    norm = float(trainer.optimizer.global_norm())
    trainer.optimizer.step()
    params = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}
    step_s = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), token_loss)
        torch.cuda.synchronize(0)
        step_s.append(time.perf_counter() - t0)
    return loss, grads, norm, params, step_s


def synchronize(cards=range(CARDS)) -> None:
    import torch

    for i in cards:
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

    ref_loss, ref_grads, ref_norm, ref_params, single_s = single_step(
        config, tc, batches[: cs.MESH_TRAIN_STEPS], seed
    )
    torch.cuda.empty_cache()
    model = init_highlighter_params(config, seed=seed, device="cuda:0")
    mesh = make_mesh(dp=2, tp=2, devices=[torch.device("cuda", i) for i in range(CARDS)])
    trainer = Trainer(model, config, tc, mesh=mesh, loss_fn=token_loss)
    sharded = trainer.model
    placement = {
        f"{d},{t}": sorted({leaf.device.index for leaf in sharded.leaves[d][t].values()})
        for d in range(2) for t in range(2)
    }
    cs.require(
        all(placement[f"{d},{t}"] == [2 * d + t] for d in range(2) for t in range(2))
        and all(p.device.type == "cpu" for p in model.parameters()),
        f"cards: leaves by position on cards {placement}, or the module holds device memory",
    )
    for i in range(CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    step_s, held = [], None
    layers = config.num_layers * mesh.size
    for step, batch in enumerate(batches[: cs.MESH_TRAIN_STEPS]):
        cs.reset_counts()
        t0 = time.perf_counter()
        if step == 0:
            step1 = cs.mesh_step_grads(trainer, batch, token_loss)
            step1["grads"] = {k: v.cpu() for k, v in step1["grads"].items()}
            loss = step1["loss"]
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
            held = cs.held_to_single(ref_loss=ref_loss, ref_grads=ref_grads, ref_norm=ref_norm, **step1)
            held.update(held_update(sharded, ref_params))
            held["worst"] = max(held["worst"], held["param_of_limit"])
            cs.require(held["worst"] <= 1.0, f"cards: step 1 differs from the single-device step: {held}")
            del step1, ref_grads, ref_params
    unequal = sharded.unequal_copies()
    cs.require(not unequal, f"cards: copies differ after step {len(step_s)}: {unequal[:8]}")
    peaks = [torch.cuda.max_memory_allocated(i) / 1e9 for i in range(CARDS)]
    resident = cs.resident_gb(sharded, trainer.optimizer)
    whole_adamw = 2 * 4 * sum(p.numel() for p in model.parameters())
    spread = {"0,2": abs(peaks[0] - peaks[2]) / max(peaks[0], peaks[2]), "1,3": abs(peaks[1] - peaks[3]) / max(peaks[1], peaks[3])}
    memory_faults = [f"card {i} holds the whole model's AdamW state" for i, r in enumerate(resident)
                     if r["optimizer_state"] >= whole_adamw]
    memory_faults += [f"cards {pair} peak {v:.3f} apart" for pair, v in spread.items() if v > MAX_PEAK_SPREAD]
    median_s = float(np.median(step_s[1:]))
    return dict(
        dp=2, tp=2, cards=CARDS, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ, step_s=step_s,
        step_s_median_2_to_3=median_s, tokens_per_s=cs.TRAIN_BATCH * cs.TRAIN_SEQ / median_s,
        single_card_step_s_2_to_3=single_s, single_card_step_s_median=float(np.median(single_s)),
        peak_memory_gb_per_card=peaks, peak_pair_spread=spread, resident_per_card=resident,
        memory_faults=memory_faults,
        whole_model_adamw_gb=whole_adamw / 1e9, copies_bit_equal=True,
        held=held, worst_of_limit=held["worst"],
    )


def worker(rank: int, port: int, seed: int, out_dir: str) -> None:
    """One process of the group: its card, its rows, step 1, then steps 2-3
    timed; writes step 1's gradients (after the group's sum) and updated
    parameters and the later steps' seconds."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import init_highlighter_params
    from verbatim_rag_tpu_torch.parallel import distributed, make_mesh
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.token_dataset import TokenBatch
    from verbatim_rag_tpu_torch.training.trainer import Trainer, sync_grads, train_step

    torch.cuda.set_device(rank)
    cs.require(distributed.initialize(f"127.0.0.1:{port}", CARDS, rank), "processes: no process group")
    cs.require("cuda:nccl" in torch.distributed.get_backend(), "processes: CUDA collectives do not run on NCCL")
    probe = torch.ones(1)
    torch.distributed.all_reduce(probe)
    cs.require(float(probe) == CARDS, "processes: a CPU collective did not run on gloo")
    config, tc, batches = batches_and_config(seed)
    rows = distributed.process_local_batch_slice(batches[0].input_ids.shape[0])
    local = [
        TokenBatch(**{name: getattr(b, name)[rows] for name in TokenBatch.__dataclass_fields__})
        for b in batches[: cs.MESH_TRAIN_STEPS]
    ]
    model = init_highlighter_params(config, seed=seed, device=f"cuda:{rank}")
    mesh = make_mesh(dp=1, tp=1, devices=[torch.device("cuda", rank)])  # joined along dp by the group
    trainer = Trainer(model, config, tc, mesh=mesh, loss_fn=token_loss)
    trainer.optimizer.zero_grad()
    loss, _ = token_loss(trainer.model, trainer.batch_to_device(local[0]))
    loss.backward()
    sync_grads(trainer.model, trainer.optimizer)
    grads = trainer.model.logical_grads()
    total = distributed.all_reduce_sum({"loss": loss.detach()}, distributed.world())["loss"]
    trainer.optimizer.step()
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    step_s = []
    for batch in local[1:]:
        torch.cuda.synchronize(rank)
        t0 = time.perf_counter()
        train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), token_loss)
        torch.cuda.synchronize(rank)
        step_s.append(time.perf_counter() - t0)
    torch.save(
        dict(loss=float(total), grads=grads, params=params, step_s=step_s),
        os.path.join(out_dir, f"rank{rank}.pt"),
    )
    torch.distributed.destroy_process_group()


def tp_worker(rank: int, port: int, seed: int, out_dir: str) -> None:
    """One rank of ``tp_processes``: its card, an NCCL group, its position
    (d, t) = (rank // 2, rank % 2) of a dp = 2 × tp = 2 global mesh; step 1
    by hand (the gradients gathered on rank 0 before clipping), steps 2-3
    timed; rank 0 holds step 1 to the single-device step in
    ``out_dir``/ref.pt."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import init_highlighter_params
    from verbatim_rag_tpu_torch.parallel import distributed, exchange
    from verbatim_rag_tpu_torch.training.model import token_loss
    from verbatim_rag_tpu_torch.training.trainer import Trainer, _group_loss, sync_grads, train_step

    torch.cuda.set_device(rank)
    cs.require(distributed.initialize(f"127.0.0.1:{port}", CARDS, rank), "tp_processes: no process group")
    config, tc, batches = batches_and_config(seed)
    card = torch.device("cuda", rank)
    mesh = distributed.global_mesh(dp=2, tp=2, devices=[card])
    cs.require(mesh.axis_group("tp", rank // 2) is not None, "tp_processes: the tp row does not span ranks")
    trainer = Trainer(init_highlighter_params(config, seed=seed, device=card), config, tc, mesh=mesh,
                      loss_fn=token_loss)
    torch.cuda.reset_peak_memory_stats(rank)
    layers = config.num_layers
    cs.reset_counts()
    trainer.optimizer.zero_grad()
    loss, _ = token_loss(trainer.model, trainer.batch_to_device(batches[0]))
    loss.backward()
    sync_grads(trainer.model, trainer.optimizer)
    grads = trainer.model.logical_grads()  # a collective: the tree on rank 0
    total = float(_group_loss(loss, trainer.model))
    norm = float(trainer.optimizer.global_norm())
    trainer.optimizer.step()
    params = trainer.model.state_dict()  # a collective
    out = dict(rank=rank, loss=total, norm=norm, launches=[cs.read_counts()], step_s=[], handoffs=[], handoff_ms=[])
    if rank == 0:
        ref = torch.load(os.path.join(out_dir, "ref.pt"), weights_only=False)
        held = cs.held_to_single(total, {k: v.cpu() for k, v in grads.items()}, ref["loss"], ref["grads"],
                                 norm=norm, ref_norm=ref["norm"])
        errors = cs.tensor_errors({k: v.detach().cpu() for k, v in params.items()}, ref["params"])
        name = max(errors, key=errors.get)
        held.update(param_worst_rel=errors[name], param_worst_tensor=name,
                    param_of_limit=errors[name] / cs.MESH_PARAM_RTOL)
        held["worst"] = max(held["worst"], held["param_of_limit"])
        out["held"] = held
    del grads, params
    for batch in batches[1 : cs.MESH_TRAIN_STEPS]:
        cs.reset_counts()
        exchange.handoffs, exchange.handoff_s = 0, 0.0
        synchronize([rank])
        torch.distributed.barrier()
        t0 = time.perf_counter()
        train_step(trainer.model, trainer.optimizer, trainer.batch_to_device(batch), token_loss)
        synchronize([rank])
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append(cs.read_counts())
        out["handoffs"].append(exchange.handoffs)
        out["handoff_ms"].append(exchange.handoff_s * 1e3)
    for i, c in enumerate(out["launches"]):
        cs.require(
            (c["flash_attention"], c["flash_bwd_dq"], c["flash_bwd_dkv"]) == (layers, layers, layers),
            f"tp_processes: rank {rank} step {i + 1} launches {c}, expected {layers} of each flash kernel",
        )
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(rank) / 1e9
    out["unequal_local"] = trainer.model.unequal_copies()
    out["leaf_sums"] = {f"{n}@{d},{t}": float(leaf.detach().double().sum()) for d, t in mesh.local_positions()
                        for n, leaf in trainer.model.leaves[d][t].items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_tp_processes(config, tc, batches, seed: int) -> dict:
    """Part ``tp_processes``: dp = 2 × tp = 2 over four NCCL ranks, the tp
    rows across ranks, held to the single-device step."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs

    ref_loss, ref_grads, ref_norm, ref_params, _ = single_step(config, tc, batches[:1], seed)
    torch.cuda.empty_cache()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        torch.save(dict(loss=ref_loss, grads=ref_grads, norm=ref_norm, params=ref_params),
                   os.path.join(out_dir, "ref.pt"))
        del ref_grads, ref_params
        t0 = time.perf_counter()
        mp.spawn(tp_worker, args=(cs.free_port(), seed, out_dir), nprocs=CARDS, join=True)
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(CARDS)]
    held = ranks[0]["held"]
    cs.require(held["worst"] <= 1.0, f"tp_processes: step 1 differs from the single-device step: {held}")
    cs.require(all((r["loss"], r["norm"]) == (ranks[0]["loss"], ranks[0]["norm"]) for r in ranks),
               "tp_processes: the ranks report different losses or norms")
    cs.require(not any(r["unequal_local"] for r in ranks), "tp_processes: a rank's copies differ")
    copies: dict = {}
    for r in ranks:
        for key, value in r["leaf_sums"].items():
            name, position = key.split("@")
            sliced = any(s in f".{name}" for s in (".attn.q.", ".attn.k.", ".attn.v.", ".attn.o.", ".mlp.w"))
            copies.setdefault((name, position.split(",")[1] if sliced else "all"), set()).add(value)
    unequal = [k for k, v in copies.items() if len(v) > 1]
    cs.require(not unequal, f"tp_processes: copies differ across ranks after step 3: {unequal[:8]}")
    step_s = [r["step_s"] for r in ranks]
    return dict(
        processes=CARDS, backend="nccl", dp=2, tp=2, tp_across_ranks=True, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
        group_s_with_start=group_s, held=held, worst_of_limit=held["worst"], ranks_equal=True,
        copies_equal_across_ranks=True, step_s_2_to_3_by_rank=step_s,
        step_s_median=float(np.median([max(s) for s in zip(*step_s)])),
        handoffs_a_step_by_rank=[r["handoffs"] for r in ranks], handoff_ms_a_step_by_rank=[r["handoff_ms"] for r in ranks],
        peak_memory_gb_by_rank=[r["peak_memory_gb"] for r in ranks],
    )


def run_processes(config, tc, batches, seed: int) -> dict:
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from verbatim_rag_tpu_torch.parallel import make_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        t0 = time.perf_counter()
        mp.spawn(worker, args=(cs.free_port(), seed, out_dir), nprocs=CARDS, join=True)
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(CARDS)]
    mesh = make_mesh(dp=CARDS, tp=1, devices=[torch.device("cuda", 0)] * CARDS)
    ref_loss, ref_grads, _, ref_params, _ = single_step(config, tc, batches[:1], seed, mesh)
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
    step_s = [r["step_s"] for r in ranks]
    return dict(processes=CARDS, backend="nccl", group_s_with_start=group_s, ranks_equal=True, held=held,
                worst_of_limit=held["worst"], step_s_2_to_3_by_rank=step_s,
                step_s_median=float(np.median([max(s) for s in zip(*step_s)])))


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
    torch.cuda.empty_cache()
    tp_processes = run_tp_processes(config, tc, batches, args.seed)
    print(card)
    print(json.dumps({"cards": cards}))
    print(json.dumps({"processes": processes}))
    print(json.dumps({"tp_processes": tp_processes}))
    cs.require(not cards["memory_faults"], f"cards: {cards['memory_faults']}")


if __name__ == "__main__":
    main()
