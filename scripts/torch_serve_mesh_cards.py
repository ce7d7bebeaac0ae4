"""Serving a sharded index on distinct NVIDIA cards, and across processes over NCCL.

    python3 scripts/torch_serve_mesh_cards.py [--seed 0]

Needs four cards: without them it exits with code 2 and prints no result.
It prints the cards' name and power limit, then one JSON line a part as the
part ends (``processes`` first, while the cards are still empty; then
``cards``, then ``sp_processes``):

- ``cards``: one process, ``make_mesh(dp=2, tp=2)`` over the four cards.
  (a) The mesh store (`DeviceVectorStore(mesh=...)`, int8 dense and sketch,
  blocks of 4 · 8192 rows) filled with 4,194,304 of `chip_smoke.bench_data`'s
  records (dense 384, sketch 768, a 128-slot forward index; 1,048,576 a
  card), beside the same store on a ``[cuda:0] * 4`` mesh of card 0; for each
  of "xla", "section" and "bucket" a first 512-query hybrid batch (top-10)
  whose hits (ids and scores) must equal the one-card store's, the section,
  v2 and rescore launches a shard and batch of `chip_smoke.py`'s mesh phase,
  then `TIMED` batches of each store by CUDA events (card 0's stream: the
  batch ends in a readback there) and the host clock, and one batch of the
  four cards under `torch.profiler`: each card's busy ms (the union of its
  kernel intervals), the ms two or more cards were busy at once and the most
  cards busy at once (`card_overlap`). (b) `chip_smoke.py`'s long_sp
  extraction: the 22.8k-token document in one pass at S=24576 through
  `ModelSpanExtractor(sp_mesh=make_mesh(dp=1, tp=4))` over the four cards
  and over ``[cuda:0] * 4``, the same seeded full-width weights: token
  probabilities within `chip_smoke.SP_PROBS_ATOL`, spans equal unless a
  probability lies within that of the threshold, 128 partial launches each,
  seconds of both and the four cards' overlap.
- ``sp_processes``: the same extraction across four processes, one card
  each (NCCL over the loopback interface): one position a rank of
  `distributed.global_mesh(dp=1, tp=4)` (6144 tokens a rank), each rank
  building the seeded weights, one untimed pass, one timed, one under
  `torch.profiler`: every rank's probabilities within
  `chip_smoke.SP_PROBS_ATOL` of the ``cards`` pass (bit-equality recorded),
  spans equal on every rank (and to the ``cards`` pass's unless a
  probability lies within that of the threshold), 32 partial launches a
  rank (8 global layers × 4 ring steps), no forward launch; each rank's
  seconds, hand-offs and their host ms (`parallel.exchange`), its card's
  busy ms and NCCL kernel ms, and across the four traces (their clocks
  joined by the traces' base time) the ms two or more cards were busy at
  once.
- ``processes``: four processes, one card each, joined by
  `parallel.distributed.initialize` (NCCL for CUDA tensors over the
  loopback interface), each making its 1,048,576 rows of
  `chip_smoke.process_block` on its card and holding them in a 1 × 1 mesh
  (`chip_smoke.serve_rank`): the five sharded searches of
  `chip_smoke.process_programs` (section, "xla", dense, projected sparse,
  exact scan) through `chip_smoke.run_programs`, every rank's scores and
  rows bit-equal to one process's ``[cuda:0] * 4`` mesh over the same
  4,194,304 rows, with `chip_smoke.plant_offset_fault` failing that; each
  rank's batch ms by CUDA events and its pair all_gathers' ms.

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
#: Rows a card: the mesh store's 4,194,304 and the processes' blocks.
CARD_ROWS = 1 << 20
TIMED = 3
#: The mesh phase's launches a shard and batch of each candidate program:
#: (kernel counter, launches).
STORE_PROGRAMS = {"xla": ("rescore", 1), "section": ("section", 1), "bucket": ("bucket_max_v2", 2)}


def synchronize(cards=range(CARDS)) -> None:
    import torch

    for i in cards:
        torch.cuda.synchronize(i)


def kernel_trace(fn, cards=range(CARDS)) -> tuple[float, dict, dict]:
    """``fn`` once under `torch.profiler`: its wall ms, each card's kernel
    intervals in µs (from the trace's base time where the trace states it,
    so that the traces of several processes share a clock) and each card's
    NCCL kernel ms."""
    from torch.profiler import ProfilerActivity, profile

    synchronize(cards)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(cards)
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    base = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    by_card: dict[int, list] = {}
    nccl_us: dict[int, float] = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            start = base + float(e["ts"])
            card = int(e.get("args", {}).get("device", e.get("pid")))
            by_card.setdefault(card, []).append((start, start + float(e["dur"])))
            if "nccl" in e.get("name", "").lower():
                nccl_us[card] = nccl_us.get(card, 0.0) + float(e["dur"])
    return wall_ms, by_card, {card: us / 1e3 for card, us in sorted(nccl_us.items())}


def overlap(by_card: dict) -> dict:
    """From each card's kernel intervals: the span from the first start to
    the last end, each card's busy ms (the union of its intervals), the ms
    two or more cards were busy at once and the most cards busy at once."""
    unions = {}
    for card, intervals in by_card.items():
        merged = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        unions[card] = merged
    edges = sorted((t, d) for u in unions.values() for a, b in u for t, d in ((a, 1), (b, -1)))
    busy, most, concurrent_us, last = 0, 0, 0.0, None
    for t, d in edges:
        if busy >= 2:
            concurrent_us += t - last
        busy += d
        most = max(most, busy)
        last = t
    span_us = edges[-1][0] - edges[0][0] if edges else 0.0
    return dict(
        span_ms=span_us / 1e3,
        busy_ms_by_card={card: sum(b - a for a, b in u) / 1e3 for card, u in sorted(unions.items())},
        kernels_by_card={card: len(by_card[card]) for card in sorted(by_card)},
        concurrent_ms=concurrent_us / 1e3, concurrent_share_of_span=concurrent_us / span_us if span_us else 0.0,
        most_cards_busy_at_once=most,
    )


def card_overlap(fn) -> dict:
    """``fn`` once under `torch.profiler` over the four cards: wall ms and
    `overlap` of the cards' kernels."""
    wall_ms, by_card, _ = kernel_trace(fn)
    return dict(wall_ms=wall_ms, **overlap(by_card))


def run_store(data, seed: int) -> dict:
    """Part (a) of ``cards``: the mesh store over four cards against the
    same store on one card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from verbatim_rag_tpu_torch.parallel import make_mesh

    meshes = {
        "cards": make_mesh(dp=2, tp=2, devices=[torch.device("cuda", i) for i in range(CARDS)]),
        "one_card": make_mesh(dp=2, tp=2, devices=[torch.device("cuda", 0)] * CARDS),
    }
    stores, fills = {}, {}
    for where, mesh in meshes.items():
        store, ingest_s, state_gb = cs.fill_store(data, mesh=mesh, block=CARDS * 8192, dense_dtype="int8",
                                                  sketch_dtype="int8")
        stores[where], fills[where] = store, dict(ingest_s=ingest_s, state_gb=state_gb, capacity=store._capacity)
    placement = [s.device.index for s in stores["cards"]._dense.shards]
    cs.require(placement == list(range(CARDS)), f"cards: the store's shards lie on cards {placement}")
    programs = {}
    for impl, (kernel, per_shard) in STORE_PROGRAMS.items():
        got = {}
        for where, store in stores.items():
            store.candidate_impl = impl
            cs.reset_counts()
            got[where], _ = cs.first_batch(store, data, 10, f"cards {where} {impl}")
            synchronize()
            counts = cs.read_counts()
            cs.require(
                counts[kernel] == per_shard * CARDS and counts["rescore"] == CARDS,
                f"cards {where} {impl}: launches {counts}",
            )
        cs.require(cs.hits(got["cards"]) == cs.hits(got["one_card"]),
                   f"cards {impl}: the four cards' hits differ from one card's")
        record = dict(hits_equal_one_card=True)
        for where, store in stores.items():
            host, events = cs.event_batches(store, data, 1, TIMED, 10)
            record[where] = dict(batch_ms=host, batch_event_ms=events, batch_event_ms_median=float(np.median(events)))
        q_dense, q_sparse, _ = data["queries"](1)
        record["cards_profile"] = card_overlap(
            lambda: stores["cards"].query_batch(dense_queries=q_dense, sparse_queries=q_sparse, top_k=10)
        )
        programs[impl] = record
        cs.log(f"cards {impl}", json.dumps(record))
    del stores
    torch.cuda.empty_cache()
    return dict(rows=cs.STORE_ROWS, fills=fills, **programs)


def run_sp(seed: int) -> dict:
    """Part (b) of ``cards``: long_sp's extraction over four cards against
    the same on one card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, modernbert_base_config
    from verbatim_rag_tpu_torch.models.tokenizer import bucket_length
    from verbatim_rag_tpu_torch.parallel import make_mesh

    config = modernbert_base_config()
    params = ModelSpanExtractor(config=config, seed=seed).model.state_dict()
    text = cs.long_document(seed)
    runs = {}
    for where, devices in (("one_card", [torch.device("cuda", 0)] * CARDS),
                           ("cards", [torch.device("cuda", i) for i in range(CARDS)])):
        sp = ModelSpanExtractor(params=params, config=config, sp_mesh=make_mesh(dp=1, tp=CARDS, devices=devices))
        sp.process(cs.LONG_QUESTION, text)
        cs.reset_counts()
        synchronize()
        t0 = time.perf_counter()
        spans = sp.process(cs.LONG_QUESTION, text)
        synchronize()
        seconds = time.perf_counter() - t0
        counts = cs.read_counts()
        global_layers = sum(config.is_global_layer(i) for i in range(config.num_layers))
        cs.require(
            counts["flash_attention_partial"] == global_layers * CARDS**2 and counts["flash_attention"] == 0,
            f"sp {where}: launches {counts}",
        )
        plan = sp._plan(cs.LONG_QUESTION, text)
        row = plan["rows"][0]
        seq = bucket_length(len(row))
        ids = np.full((1, seq), sp.tokenizer.pad_id, np.int32)
        mask = np.zeros((1, seq), np.int32)
        ids[0, : len(row)], mask[0, : len(row)] = row, 1
        runs[where] = dict(sp=sp, spans=spans, seconds=seconds, probs=sp._forward_probs(ids, mask)[0][: len(row)],
                           seq=seq, partial_launches=counts["flash_attention_partial"])
    diff = float(np.abs(runs["cards"]["probs"] - runs["one_card"]["probs"]).max())
    near = int((np.abs(runs["one_card"]["probs"] - runs["one_card"]["sp"].threshold) <= cs.SP_PROBS_ATOL).sum())
    same_spans = runs["cards"]["spans"] == runs["one_card"]["spans"]
    cs.require(diff <= cs.SP_PROBS_ATOL, f"sp: the four cards' probabilities differ from one card's by {diff}")
    cs.require(same_spans or near > 0, "sp: spans differ with no probability near the threshold")
    sp = runs["cards"]["sp"]
    profile = card_overlap(lambda: sp.process(cs.LONG_QUESTION, text))
    result = dict(
        seq=runs["cards"]["seq"], shards=CARDS, probs_max_abs_diff_vs_one_card=diff, spans_equal=same_spans,
        tokens_within_tol_of_threshold=near, seconds={w: r["seconds"] for w, r in runs.items()},
        partial_launches={w: r["partial_launches"] for w, r in runs.items()}, cards_profile=profile,
    )
    cs.log("cards sp", json.dumps(result))
    cards = dict(probs=runs["cards"]["probs"], spans=runs["cards"]["spans"], threshold=sp.threshold,
                 seconds=runs["cards"]["seconds"])
    del runs, sp
    torch.cuda.empty_cache()
    return result, cards


def sp_worker(rank: int, port: int, seed: int, out_dir: str) -> None:
    """One rank of ``sp_processes``: its card, an NCCL group, its position
    of the global sequence axis, the seeded weights; written to
    ``out_dir``/rank<r>.pt."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import ModelSpanExtractor, modernbert_base_config
    from verbatim_rag_tpu_torch.parallel import distributed, exchange

    torch.cuda.set_device(rank)
    cs.require(distributed.initialize(f"127.0.0.1:{port}", CARDS, rank), "sp_processes: no process group")
    cs.require("cuda:nccl" in torch.distributed.get_backend(), "sp_processes: CUDA collectives do not run on NCCL")
    card = torch.device("cuda", rank)
    mesh = distributed.global_mesh(dp=1, tp=CARDS, devices=[card])
    sp = ModelSpanExtractor(config=modernbert_base_config(), seed=seed, sp_mesh=mesh, device=card)
    text = cs.long_document(seed)
    sp.process(cs.LONG_QUESTION, text)
    probs, forward = [], sp._forward_probs
    sp._forward_probs = lambda ids, mask: probs.append(forward(ids, mask)) or probs[-1]
    cs.reset_counts()
    exchange.handoffs, exchange.handoff_s = 0, 0.0
    synchronize([rank])
    torch.distributed.barrier()
    t0 = time.perf_counter()
    spans = sp.process(cs.LONG_QUESTION, text)
    synchronize([rank])
    seconds = time.perf_counter() - t0
    launches, handoffs, handoff_ms = cs.read_counts(), exchange.handoffs, exchange.handoff_s * 1e3
    torch.distributed.barrier()
    wall_ms, by_card, nccl_ms = kernel_trace(lambda: sp.process(cs.LONG_QUESTION, text), [rank])
    out = dict(
        rank=rank, seconds=seconds, spans=spans, launches=launches, handoffs=handoffs, handoff_ms=handoff_ms,
        probs=probs[0][0][: len(sp._plan(cs.LONG_QUESTION, text)["rows"][0])], profile_wall_ms=wall_ms,
        intervals=by_card, nccl_ms_by_card=nccl_ms,
    )
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_sp_processes(seed: int, cards: dict) -> dict:
    """Part ``sp_processes``: four NCCL ranks, one card each, against the
    ``cards`` pass (one process, four cards)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    from verbatim_rag_tpu_torch.models import modernbert_base_config

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        t0 = time.perf_counter()
        mp.spawn(sp_worker, args=(cs.free_port(), seed, out_dir), nprocs=CARDS, join=True)
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(CARDS)]
    config = modernbert_base_config()
    expected = sum(config.is_global_layer(i) for i in range(config.num_layers)) * CARDS
    for r in ranks:
        cs.require(
            r["launches"]["flash_attention_partial"] == expected and r["launches"]["flash_attention"] == 0,
            f"sp_processes: rank {r['rank']} launches {r['launches']}, expected {expected} partial, no forward",
        )
    diffs = [float(np.abs(r["probs"] - cards["probs"]).max()) for r in ranks]
    cs.require(max(diffs) <= cs.SP_PROBS_ATOL, f"sp_processes: probabilities differ from the cards pass by {diffs}")
    cs.require(all(r["spans"] == ranks[0]["spans"] for r in ranks), "sp_processes: the ranks decode different spans")
    bit_equal = all(np.array_equal(r["probs"], cards["probs"]) for r in ranks)
    near = 0 if bit_equal else int((np.abs(cards["probs"] - cards["threshold"]) <= max(diffs)).sum())
    same = ranks[0]["spans"] == cards["spans"]
    cs.require(same or near > 0, "sp_processes: spans differ from the cards pass with no probability near the threshold")
    by_card = {card: iv for r in ranks for card, iv in r["intervals"].items()}
    windows = [(min(a for a, _ in iv), max(b for _, b in iv)) for iv in by_card.values()]
    result = dict(
        processes=CARDS, backend="nccl", tokens=int(cards["probs"].shape[0]),
        probs_bit_equal_cards_pass=bit_equal, probs_max_abs_diff_by_rank=diffs, spans_equal_on_every_rank=True,
        spans_equal_cards_pass=same, partial_launches_by_rank=[r["launches"]["flash_attention_partial"] for r in ranks],
        seconds_by_rank=[r["seconds"] for r in ranks], cards_pass_seconds=cards["seconds"],
        handoffs_by_rank=[r["handoffs"] for r in ranks], handoff_ms_by_rank=[r["handoff_ms"] for r in ranks],
        nccl_kernel_ms_by_rank=[r["nccl_ms_by_card"] for r in ranks],
        profile_wall_ms_by_rank=[r["profile_wall_ms"] for r in ranks], group_s_with_start=group_s,
        traces_share_a_clock=max(a for a, _ in windows) < min(b for _, b in windows), overlap=overlap(by_card),
    )
    cs.log("sp_processes", json.dumps(result))
    return result


def worker(rank: int, port: int, seed: int, out_dir: str) -> None:
    """One rank of ``processes``: its card, an NCCL group,
    `chip_smoke.serve_rank` of the five programs on a 1 × 1 mesh."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.parallel import distributed, make_mesh

    torch.cuda.set_device(rank)
    cs.require(distributed.initialize(f"127.0.0.1:{port}", CARDS, rank), "processes: no process group")
    cs.require("cuda:nccl" in torch.distributed.get_backend(), "processes: CUDA collectives do not run on NCCL")
    mesh = make_mesh(dp=1, tp=1, devices=[torch.device("cuda", rank)])
    cs.serve_rank(rank, seed, CARD_ROWS, mesh, cs.PROC_PROGRAMS, out_dir)
    torch.distributed.destroy_process_group()


def run_processes(seed: int) -> dict:
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
    oracle = cs.one_process_oracle(seed, CARDS, CARD_ROWS, mesh, cs.PROC_PROGRAMS)
    held = cs.held_to_one_process(ranks, oracle, cs.PROC_PROGRAMS, 1, "processes")
    return dict(processes=CARDS, backend="nccl", rows=CARDS * CARD_ROWS, rows_a_rank=CARD_ROWS,
                rows_made_s_by_rank=[r["rows_made_s"] for r in ranks], group_s_with_start=group_s,
                planted_offset_caught=True, programs=held)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        sys.stderr.write(f"torch_serve_mesh_cards: no CUDA device or fewer than {CARDS} cards\n")
        raise SystemExit(2)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import chip_smoke as cs
    from verbatim_rag_tpu_torch.ops import cuda_build

    print(cs.gpu_name_and_limit(), flush=True)
    cuda_build.build_all()
    print(json.dumps({"processes": run_processes(args.seed)}), flush=True)
    torch.cuda.empty_cache()
    cs.STORE_ROWS = CARDS * CARD_ROWS
    data = cs.bench_data(args.seed)
    store = run_store(data, args.seed)
    del data
    sp, cards = run_sp(args.seed)
    print(json.dumps({"cards": dict(store=store, sp=sp)}), flush=True)
    print(json.dumps({"sp_processes": run_sp_processes(args.seed, cards)}), flush=True)


if __name__ == "__main__":
    main()
