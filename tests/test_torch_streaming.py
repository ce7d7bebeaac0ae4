"""`StreamingRAG` and the profiling helpers of the port, on the CPU.

The stream runs over the same index and extractor weights as the JAX
package's (hashed providers, exact selection, one tiny ModernBERT-style
extractor carried with `params_from_jax`): the events, their order and
their data must be equal, floats within rtol/atol 5e-4, host-clock fields
aside. The profiling helpers (`StageTimer`, the Chrome-trace busy time,
`block_and_time`, `DeviceTrace`) are checked on the CPU.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine.embedding_providers import HashedBowDenseProvider as JaxDense
from verbatim_rag_tpu.engine.embedding_providers import HashedSparseProvider as JaxSparse
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.highlighter import ModelSpanExtractor as JaxExtractor
from verbatim_rag_tpu.models.highlighter import init_highlighter_params
from verbatim_rag_tpu.rag import StreamingRAG as JaxStreamingRAG
from verbatim_rag_tpu.rag import VerbatimRAG as JaxRAG
from verbatim_rag_tpu.utils.profiling import StageTimer as JaxStageTimer
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import ModelSpanExtractor
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax
from verbatim_rag_tpu_torch.rag import StreamingRAG, VerbatimRAG
from verbatim_rag_tpu_torch.utils import profiling

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))
EXTRACTOR = dict(
    vocab_size=1024, hidden_size=32, num_heads=2, num_layers=3, intermediate_size=32,
    max_position_embeddings=8192, position_embedding_type="rope", norm_location="pre",
    activation="geglu", use_bias=False, final_norm=True, type_vocab_size=0,
    first_layer_no_attn_norm=True, layer_norm_eps=1e-5, local_attention_window=16,
    use_flash_attention=True,
)
K = 3
RTOL = ATOL = 5e-4
STREAMS = [
    ("How efficient are solar panels?", {}),
    ("Where do offshore wind farms get steadier wind?", dict(k=2, search_type="dense")),
    ("How is energy stored for the night?", dict(search_type="sparse", rrf_k=10)),
    ("solar", dict(filter={"title": "wind.md"}, hybrid_weights={"dense": 1.0, "sparse": 3.0})),
    ("wind", dict(template_mode="question_specific")),
    ("wind", dict(filter="title == ")),  # retrieval fails: an error event
    ("solar", dict(k=5, filter="title == 'nothing.md'")),  # no documents
]


def _counted_ingest(index, docs):
    counter = itertools.count()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        index.add_documents(docs)


@pytest.fixture(scope="module")
def streams():
    params = init_highlighter_params(jax.random.PRNGKey(13), jax_tiny_config(**EXTRACTOR))
    jax_index = JaxIndex(dense_provider=JaxDense(dim=64), sparse_provider=JaxSparse(), approx_topk=False)
    _counted_ingest(jax_index, [JaxSchema.from_file(str(p)) for p in DOCS])
    index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(dim=64), sparse_provider=HashedSparseProvider(), device="cpu"
    )
    _counted_ingest(index, [DocumentSchema.from_file(str(p)) for p in DOCS])
    extractor = ModelSpanExtractor(
        params=params_from_jax(jax.tree.map(np.asarray, params)), config=tiny_test_config(**EXTRACTOR),
        device="cpu",
    )
    return {
        "jax": JaxStreamingRAG(
            JaxRAG(jax_index, extractor=JaxExtractor(params=params, config=jax_tiny_config(**EXTRACTOR)), k=K)
        ),
        "port": StreamingRAG(VerbatimRAG(index, extractor=extractor, k=K)),
    }


def blank_clock(events):
    for event in events:
        if "elapsed_ms" in event:
            event["elapsed_ms"] = None
        for stage in event.get("timings", []):
            stage["elapsed_ms"] = None
    return events


def assert_close(got, expected, where="event"):
    if isinstance(expected, float) or isinstance(got, float):
        assert got == pytest.approx(expected, rel=RTOL, abs=ATOL), where
    elif isinstance(expected, dict):
        assert isinstance(got, dict) and got.keys() == expected.keys(), where
        for key in expected:
            assert_close(got[key], expected[key], f"{where}.{key}")
    elif isinstance(expected, list):
        assert isinstance(got, list) and len(got) == len(expected), where
        for i, (a, b) in enumerate(zip(got, expected)):
            assert_close(a, b, f"{where}[{i}]")
    else:
        assert got == expected, where


@pytest.mark.parametrize("i", range(len(STREAMS)))
def test_stream_matches_jax(streams, i):
    question, kwargs = STREAMS[i]
    got = blank_clock(streams["port"].stream_query_sync(question, **kwargs))
    expected = blank_clock(streams["jax"].stream_query_sync(question, **kwargs))
    assert_close(got, expected)
    types = [e["type"] for e in got]
    assert types in (["documents", "progress", "highlights", "answer"], ["error"])
    if types == ["error"]:
        assert got[0]["stage"] == "retrieval"
    else:
        assert got[-1]["done"] and [t["stage"] for t in got[-1]["timings"]] == [
            "retrieve", "extract", "highlight", "template"
        ]


def test_stream_answer_equals_query(streams):
    """The stream's final answer is `VerbatimRAG.query`'s, and its
    highlights index their chunks verbatim."""
    rag = streams["port"].rag
    for question, kwargs in STREAMS[:3]:
        events = streams["port"].stream_query_sync(question, **kwargs)
        expected = rag.query(question, **kwargs).model_dump()
        assert events[-1]["data"] == expected
        assert events[2]["data"]["documents"] == expected["documents"]
        for d in expected["documents"]:
            for h in d["highlights"]:
                assert d["content"][h["start"] : h["end"]] == h["text"]


def test_extraction_and_template_failures_become_error_events(streams, monkeypatch):
    rag = streams["port"].rag

    def boom(*args, **kwargs):
        raise RuntimeError("extractor down")

    monkeypatch.setattr(rag.extractor, "extract_spans", boom)
    events = streams["port"].stream_query_sync("solar")
    assert [e["type"] for e in events] == ["documents", "error"] and events[1]["stage"] == "extraction"
    monkeypatch.undo()
    monkeypatch.setattr(rag.template_manager, "process_async", boom)
    events = streams["port"].stream_query_sync("solar")
    assert [e["type"] for e in events][-1] == "error" and events[-1]["stage"] == "template"


def test_concurrent_streams_keep_their_own_k(streams):
    async def both():
        async def collect(k):
            return [e async for e in streams["port"].stream_query("solar panels", k=k)]

        return await asyncio.gather(collect(1), collect(4))

    one, four = asyncio.run(both())
    assert len(one[0]["data"]["documents"]) == 1 and len(four[0]["data"]["documents"]) == 4
    assert streams["port"].rag.k == K


# -- profiling ----------------------------------------------------------------------


def test_stage_timer_matches_jax(monkeypatch):
    clock = itertools.count(step=0.0125)
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    timers = []
    for cls in (profiling.StageTimer, JaxStageTimer):
        timer = cls()
        for name in ("retrieve", "extract"):
            with timer.stage(name):
                pass
        with pytest.raises(KeyError):
            with timer.stage("template"):
                raise KeyError("x")
        timers.append((timer.stages, timer.events(), timer.total_ms()))
    assert timers[0] == timers[1]
    assert [s["stage"] for s in timers[0][0]] == ["retrieve", "extract", "template"]


@pytest.mark.parametrize(
    "intervals,expected_ms",
    [
        ([], 0.0),
        ([(0, 1000)], 1.0),
        ([(0, 1000), (500, 1000)], 1.5),  # overlapping: the union, not the sum
        ([(0, 1000), (100, 200), (2000, 500)], 1.5),  # nested, then a gap
        ([(3000, 10), (0, 10), (5, 10)], 0.025),  # any order
    ],
)
def test_busy_ms_is_the_union_of_intervals(intervals, expected_ms):
    assert profiling.busy_ms(intervals) == pytest.approx(expected_ms)


def test_trace_busy_ms_reads_kernel_events(tmp_path):
    """Only complete CUDA kernel events count; the newest trace is read."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 120.0, "dur": 80.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 300.0, "dur": 40.0},
        {"ph": "f", "cat": "kernel", "name": "flow", "ts": 0.0},
    ]
    (tmp_path / "old").mkdir()
    (tmp_path / "old" / "trace.json").write_text(json.dumps({"traceEvents": events[:1]}))
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    import os

    os.utime(tmp_path / "old" / "trace.json", (0, 0))
    assert profiling.trace_device_busy_ms(str(tmp_path)) == pytest.approx(0.1)
    with pytest.raises(RuntimeError, match="no Chrome trace"):
        profiling.trace_device_busy_ms(str(tmp_path / "empty"))


def test_device_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "t"), device="cpu") as trace:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert trace.device.type == "cpu"
    data = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    assert any("mm" in e.get("name", "") for e in data["traceEvents"])
    assert profiling.trace_device_busy_ms(str(tmp_path / "t")) == 0.0


def test_block_and_time_on_the_cpu():
    seconds, out = profiling.block_and_time(lambda a, b: {"c": (a @ b, 3)}, torch.ones(8, 8), torch.ones(8, 8), device="cpu")
    assert seconds >= 0.0 and torch.equal(out["c"][0], torch.full((8, 8), 8.0))
    assert profiling._first_tensor(({"x": 1}, [None, torch.zeros(1)])) is not None
    assert profiling._first_tensor((1, "a")) is None


def test_device_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """`device=None` means the card: with none, the trace and the timer
    raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.DeviceTrace(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.block_and_time(lambda: None)
