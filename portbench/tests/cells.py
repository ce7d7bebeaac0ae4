"""Each driver's cell at a size the CPU runs in seconds: the cells of
``BENCHMARK.json`` with their widths, depths and corpora cut down, and
limits taken from their files."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def _load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def tiny_rag(traffic: str = "burst64") -> dict:
    cfg = _load("configs", "rag-modernbert-base")
    cfg["extractor"].update(
        vocab_size=512, hidden_size=64, num_hidden_layers=3, num_attention_heads=2,
        intermediate_size=96, max_position_embeddings=512, local_attention=16, max_length=256,
        doc_stride=32,
    )
    cfg["providers"].update(
        vocab_size=1000, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, max_position_embeddings=128, max_length=128, dense_batch=8,
        splade_batch=4, splade_max_nnz=16,
    )
    cfg["store"]["projection_dim"] = 64
    cfg["store"]["rescore_depth"] = 64
    t = _load("traffic", traffic)
    t["corpus"].update(chunks=32, sections_per_doc=4 if traffic == "burst64" else 1, vocabulary=400)
    if t["corpus"]["lengths"]["dist"] == "lognormal":
        t["corpus"]["lengths"].update(median=40, p99=200, cap=300, min=16)
    else:
        t["corpus"]["lengths"].update(low=200, high=300, min=200, cap=300)
    t["questions"].update(per_call=4, batches=4)
    if "padded_length" in t["questions"]:
        t["questions"].update(padded_length=256, candidates=16)
    return _cell(cfg, t, "rag-modernbert-base." + traffic)


def tiny_hybrid() -> dict:
    cfg = _load("configs", "hybrid-1m-bf16")
    cfg.update(rows=3000, dense_dim=32, sparse_vocab=2000, sparse_max_nnz=16, projection_dim=64,
               query_terms=8, rescore_depth=64)
    t = _load("traffic", "b512")
    t.update(batch=16, batches=6, check_from=4, check_batches=3)
    return _cell(cfg, t, "hybrid-1m-bf16.b512")


def _cell(cfg, traffic, workload):
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    return dict(
        cell=cell, cfg=cfg, traffic=traffic,
        limits=_load("limits", workload)["limits"],
        end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]),
    )
