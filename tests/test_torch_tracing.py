"""The port's own spans and counters (`verbatim_rag_tpu_torch/utils/profiling.py`)
at its layer boundaries, on the CPU.

With no profiler a span is one shared object that does nothing, and the
store, the extractor and the RAG record nothing. Under `torch.profiler`
the same calls record their stages with their parents and one call id a
root, the Chrome trace holds them as ``vrag.*`` user annotations, the
extractor's counters equal the padding arithmetic of the arrays its forward
receives and the tokens and attention slots its packed forward runs, and
results are the same as without the profiler. JAX-free: the port's hashed
providers and narrow encoders.
"""

from __future__ import annotations

import asyncio
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from verbatim_rag_tpu_torch.engine.embedding_providers import HashedBowDenseProvider, HashedSparseProvider
from verbatim_rag_tpu_torch.engine.index import VerbatimIndex
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
from verbatim_rag_tpu_torch.ingestion.document import Document
from verbatim_rag_tpu_torch.models.config import minilm_config, tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor
from verbatim_rag_tpu_torch.models.providers import JaxDenseProvider, JaxSpladeProvider
from verbatim_rag_tpu_torch.models.tokenizer import bucket_length
from verbatim_rag_tpu_torch.rag import VerbatimRAG
from verbatim_rag_tpu_torch.utils import profiling

TEXTS = [
    "solar panels convert sunlight into electricity",
    "wind turbines convert wind into electricity",
    "battery storage smooths solar output at night",
    "offshore wind farms see steadier wind",
    "hydro power stores energy in reservoirs",
    "grid operators balance supply and demand",
    "geothermal plants tap heat from the earth",
    "panels and turbines both feed the grid",
]
QUERIES = ["solar panels electricity", "wind turbines", "battery storage at night"]
DENSE = HashedBowDenseProvider(dim=64)
SPARSE = HashedSparseProvider(vocab_size=4096)
STORE = ("store.query_batch", "store.flush", "store.prepare", "store.program", "store.readback", "store.materialize")
EXTRACT = ("extract.plan", "extract.pad", "extract.forward", "extract.decode")


def _store(**options) -> DeviceVectorStore:
    store = DeviceVectorStore(
        dense_dim=64, sparse_vocab=4096, sparse_max_nnz=8, projection_dim=32, block=16,
        device="cpu", **options,
    )
    dense, sparse = DENSE.embed_batch(TEXTS), SPARSE.embed_batch(TEXTS)
    store.add_vectors([
        {"id": f"r{i}", "text": t, "metadata": {"document_id": f"d{i % 3}"}, "dense": dense[i], "sparse": sparse[i]}
        for i, t in enumerate(TEXTS)
    ])
    return store


#: Store routes: (store options, query_batch arguments, the stages each takes).
ROUTES = {
    "hybrid": ({}, dict(dense=True, sparse=True), STORE),
    "dense": ({}, dict(dense=True, search_type="dense"), STORE),
    "sparse": ({}, dict(sparse=True, search_type="sparse"), STORE),
    "rrf": ({"sparse_mode": "exact"}, dict(dense=True, sparse=True), STORE),
    "filter": ({}, dict(filter={"document_id": "d1"}), tuple(s for s in STORE if s != "store.program")),
}


def _query(store, dense=False, sparse=False, **kwargs):
    return store.query_batch(
        dense_queries=DENSE.embed_batch(QUERIES) if dense else None,
        sparse_queries=SPARSE.embed_batch(QUERIES) if sparse else None,
        top_k=3, **kwargs,
    )


@pytest.fixture(scope="module")
def extractor():
    return ModelSpanExtractor(
        config=tiny_test_config(max_position_embeddings=64), max_length=64, doc_stride=8, device="cpu", seed=0
    )


def _pairs():
    """Three questions' results: five documents of one window and one of
    several, seven rows in all (not a power of two)."""
    long = " ".join(TEXTS * 3)
    Hit = type("Hit", (), {})
    jobs = []
    for q, texts in ((QUERIES[0], TEXTS[:2]), (QUERIES[1], [long]), (QUERIES[2], TEXTS[2:4])):
        hits = []
        for t in texts:
            hits.append(Hit())
            hits[-1].text = t
        jobs.append((q, hits))
    return jobs


def _profiled(fn, summary=False):
    """``fn()`` under a CPU profiler: (its result, the spans, the counters,
    the trace's ``vrag.*`` annotation names[, the summary])."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {e.name for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)}
    got = (out, profiling.spans(), profiling.counters(), names) + ((profiling.summary(),) if summary else ())
    profiling.reset()
    return got


def _calls_share_roots(spans):
    """Every span carries its root's call id, and each root has its own."""
    roots = [s for s in spans if s.parent is None]
    assert len({s.call for s in roots}) == len(roots)
    for s in spans:
        if s.parent is not None:
            assert s.call in {r.call for r in roots if r.start_ns <= s.start_ns and s.end_ns <= r.end_ns}


def test_no_profiler_no_span(extractor):
    assert not profiling.tracing()
    profiling.reset()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        with profiling.span("c"):
            profiling.count("x", 3)
    _query(_store(), dense=True, sparse=True)
    extractor.extract_spans_multi(_pairs())
    assert profiling.spans() == [] and profiling.counters() == {}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_store_routes_record_the_same_stages(route):
    options, args, stages = ROUTES[route]
    store = _store(**options)
    plain = _query(store, **args)
    traced, spans, counters, names = _profiled(lambda: _query(store, **args))
    assert [[(h.id, h.score) for h in r] for r in traced] == [[(h.id, h.score) for h in r] for r in plain]
    assert {s.name for s in spans} == set(stages)
    assert names == {profiling.SPAN_PREFIX + s for s in stages}
    assert [s.name for s in spans if s.parent is None] == ["store.query_batch"]
    assert {s.parent for s in spans if s.parent is not None} == {"store.query_batch"}
    assert len({s.call for s in spans}) == 1
    assert counters == {"store.queries": len(plain), "store.hits": sum(len(r) for r in plain)}


def test_extractor_counts_its_padding(extractor):
    plain = extractor.extract_spans_multi(_pairs())
    seen = []
    forward = extractor._forward_probs

    def recording(ids, mask):
        seen.append(mask.copy())
        return forward(ids, mask)

    extractor._forward_probs = recording
    try:
        traced, spans, counters, names = _profiled(lambda: extractor.extract_spans_multi(_pairs()))
    finally:
        del extractor._forward_probs
    assert traced == plain
    mask = np.concatenate(seen)
    rows = [r for q, hits in _pairs() for h in hits for r in extractor._plan(q, h.text)["rows"]]
    live_rows = int((mask.sum(axis=1) > 0).sum())
    assert len(rows) == live_rows == 7
    seq = min(bucket_length(max(map(len, rows))), extractor.max_length)
    # The forward runs the live tokens alone; attention takes each slice's
    # live rows at its longest row rounded up to a key tile, at most seq.
    attn_slots = sum(
        int((m.sum(axis=1) > 0).sum()) * min(seq, -(-int(m.sum(axis=1).max()) // 128) * 128) for m in seen
    )
    assert counters == {
        "extract.rows": 7, "extract.padded_rows": 8, "extract.slots": mask.size,
        "extract.live_slots": int(mask.sum()), "extract.row_pad_slots": (8 - 7) * seq,
        "extract.slices": len(seen), "extract.packed_tokens": int(mask.sum()), "extract.attn_slots": attn_slots,
    }
    assert counters["extract.packed_tokens"] == counters["extract.live_slots"]
    assert counters["extract.attn_slots"] <= counters["extract.slots"]
    assert mask.shape == (8, seq)
    assert [s.name for s in spans] == list(EXTRACT[:2]) + ["extract.forward"] * len(seen) + ["extract.decode"]
    assert names == {profiling.SPAN_PREFIX + s for s in EXTRACT}
    _calls_share_roots(spans)


def test_rag_spans_nest_under_one_call(extractor):
    cfg = minilm_config(
        hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128, vocab_size=1024,
        max_position_embeddings=128, compute_dtype="float32",
    )
    index = VerbatimIndex(
        dense_provider=JaxDenseProvider(config=cfg, max_length=128, batch_size=2, device="cpu"),
        sparse_provider=JaxSpladeProvider(config=cfg, max_length=128, batch_size=2, max_nnz=16, device="cpu"),
        device="cpu",
    )
    index.add_documents([Document(content=t, id=f"doc-{i}") for i, t in enumerate(TEXTS)])
    rag = VerbatimRAG(index, extractor=extractor, k=2)
    plain = rag.query_batch(QUERIES)
    traced, spans, counters, names, summary = _profiled(lambda: rag.query_batch(QUERIES), summary=True)
    assert [r.model_dump() for r in traced] == [r.model_dump() for r in plain]
    parents = {}
    for s in spans:
        parents.setdefault(s.name, set()).add(s.parent)
    expected = {
        "rag.query_batch": {None}, "rag.respond": {"rag.query_batch"},
        "index.query_batch": {"rag.query_batch"},
        "encode.dense": {"index.query_batch"}, "encode.sparse": {"index.query_batch"},
        "encode.tokenize": {"encode.dense", "encode.sparse"}, "encode.forward": {"encode.dense", "encode.sparse"},
        "store.query_batch": {"index.query_batch"},
        **{s: {"store.query_batch"} for s in STORE[1:]},
        **{s: {"rag.query_batch"} for s in EXTRACT},
    }
    assert parents == expected
    assert names == {profiling.SPAN_PREFIX + n for n in expected}
    assert len({s.call for s in spans}) == 1
    assert counters["rag.questions"] == len(QUERIES)
    assert counters["store.queries"] == len(QUERIES)
    root = summary["rag.query_batch"]
    children = sum(v["total_ms"] for n, v in summary.items() if expected[n] == {"rag.query_batch"})
    assert root["count"] == 1
    assert root["self_ms"] == pytest.approx(root["total_ms"] - children)


def test_threads_keep_their_own_parents():
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"{tag}.root"):
            barrier.wait()
            with profiling.span(f"{tag}.child"):
                barrier.wait()

    def both():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

    _, spans, _, _ = _profiled(both)
    by_name = {s.name: s for s in spans}
    assert set(by_name) == {"a.root", "a.child", "b.root", "b.child"}
    for tag in ("a", "b"):
        assert by_name[f"{tag}.root"].parent is None
        assert by_name[f"{tag}.child"].parent == f"{tag}.root"
        assert by_name[f"{tag}.child"].call == by_name[f"{tag}.root"].call
    assert by_name["a.root"].call != by_name["b.root"].call


def test_stage_timer_stages_are_stream_spans():
    timer = profiling.StageTimer()

    def run():
        for name in ("retrieve", "extract"):
            with timer.stage(name):
                with profiling.span("inner"):
                    pass

    _, spans, _, names = _profiled(run)
    assert [(s.name, s.parent) for s in spans] == [
        ("inner", "stream.retrieve"), ("stream.retrieve", None), ("inner", "stream.extract"), ("stream.extract", None),
    ]
    assert names == {"vrag.stream.retrieve", "vrag.stream.extract", "vrag.inner"}
    assert [s["stage"] for s in timer.stages] == ["retrieve", "extract"]


def test_spans_past_the_bound_are_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)

    def run():
        for _ in range(5):
            with profiling.span("s"):
                profiling.count("n", 1)

    _, spans, counters, _ = _profiled(run)
    assert len(spans) == 3
    assert counters == {"n": 5, "trace.dropped_spans": 2}


def test_device_trace_holds_a_worker_threads_spans(tmp_path):
    """`DeviceTrace` (the server's `/api/debug/trace`) records the spans of
    `asyncio.to_thread`'s worker beside the main thread's, and starting it
    clears what an earlier session recorded."""
    store = _store()

    async def served():
        return await asyncio.to_thread(_query, store, dense=True, sparse=True)

    with profiling.device_trace(str(tmp_path), device="cpu"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("earlier"):
            pass
    assert profiling.spans()
    with profiling.device_trace(str(tmp_path), device="cpu"):
        with profiling.span("main"):
            asyncio.run(served())
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    annotated = {(e["name"], e["tid"]) for e in events if e.get("cat") == "user_annotation"}
    names = {n for n, _ in annotated}
    assert names == {"vrag.main"} | {profiling.SPAN_PREFIX + s for s in STORE}
    main_tid = {t for n, t in annotated if n == "vrag.main"}
    assert {t for n, t in annotated if n == "vrag.store.query_batch"}.isdisjoint(main_tid)
    assert {s.name for s in profiling.spans()} == {"main"} | set(STORE)
    profiling.reset()
