"""The PyTorch port's HTTP server against the JAX package's, route by route.

Both packages ingest `examples/example_docs` with the hashed providers
(exact selection: ``approx_topk=False`` in the JAX store) and answer
through one tiny ModernBERT-style extractor, its weights carried from JAX
with `params_from_jax`; the transform route's offline extractor gets the
same weights on both sides. Every request goes through aiohttp's test
client to the JAX `create_app()` and to the port's; status, body and the
CORS headers must be equal, floats (scores) within rtol/atol 5e-4. The
micro-batcher is held to the JAX one on the same arrivals.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import uuid
from pathlib import Path

import numpy as np
import pytest

import jax
from aiohttp.test_utils import TestClient, TestServer

from verbatim_rag_tpu.api import app as jax_app
from verbatim_rag_tpu.api import batching as jax_batching
from verbatim_rag_tpu.api import dependencies as jax_deps
from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine.embedding_providers import HashedBowDenseProvider as JaxDense
from verbatim_rag_tpu.engine.embedding_providers import HashedSparseProvider as JaxSparse
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.highlighter import ModelSpanExtractor as JaxExtractor
from verbatim_rag_tpu.models.highlighter import init_highlighter_params
from verbatim_rag_tpu.rag import VerbatimRAG as JaxRAG
from verbatim_rag_tpu_torch.api import app
from verbatim_rag_tpu_torch.api import batching
from verbatim_rag_tpu_torch.api import dependencies as deps
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import ModelSpanExtractor
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax
from verbatim_rag_tpu_torch.rag import VerbatimRAG

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))
EXTRACTOR = dict(
    vocab_size=1024, hidden_size=32, num_heads=2, num_layers=3, intermediate_size=32,
    max_position_embeddings=8192, position_embedding_type="rope", norm_location="pre",
    activation="geglu", use_bias=False, final_norm=True, type_vocab_size=0,
    first_layer_no_attn_norm=True, layer_norm_eps=1e-5, local_attention_window=16,
    use_flash_attention=True,
)
K = 3
#: Floats on the wire (scores computed in float32 by two programs).
RTOL = ATOL = 5e-4
QUESTIONS = [
    "How efficient are solar panels?",
    "Where do offshore wind farms get steadier wind?",
    "How is energy stored for the night?",
]
CONTEXT = [
    {"content": "Solar panels convert sunlight into electricity. Modern panels reach about 22% efficiency.",
     "title": "Solar"},
    "Offshore wind farms see steadier and stronger winds than sites on land.",
    {"text": "Batteries store daytime solar energy for use at night.", "metadata": {"kind": "note"}},
]

#: (method, path, body) sent to both servers; a str body goes raw.
ROUTES = [
    ("GET", "/api/status", None),
    ("GET", "/api/documents", None),
    ("GET", "/api/templates", None),
    ("POST", "/api/query", {"question": QUESTIONS[0]}),
    ("POST", "/api/query", {"question": QUESTIONS[1], "k": 2, "search_type": "dense"}),
    ("POST", "/api/query", {"question": QUESTIONS[2], "search_type": "sparse", "rrf_k": 10}),
    ("POST", "/api/query", {"question": QUESTIONS[0], "hybrid_weights": {"dense": 2.0, "sparse": 0.5}}),
    ("POST", "/api/query", {"question": QUESTIONS[1], "filter": "title == 'wind.md'"}),
    ("POST", "/api/query", {"question": QUESTIONS[0], "filter": {"title": "solar.md"}, "k": 5}),
    ("POST", "/api/query", {"question": QUESTIONS[2], "template_mode": "question_specific"}),
    ("POST", "/api/query_async", {"question": QUESTIONS[1]}),
    ("POST", "/api/query/async", {"question": QUESTIONS[2], "k": 1}),
    ("POST", "/api/query/stream", {"question": QUESTIONS[0]}),
    ("POST", "/api/query/stream", {"question": QUESTIONS[1], "k": 2, "search_type": "hybrid"}),
    ("POST", "/api/transform/verbatim", {"question": QUESTIONS[0], "context": CONTEXT}),
    ("POST", "/api/transform/verbatim", {"question": QUESTIONS[1], "sources": CONTEXT[1:]}),
    # Probes: every one a 4xx with the CORS headers.
    ("POST", "/api/query", {"question": ""}),
    ("POST", "/api/query", {"question": "x" * 1001}),
    ("POST", "/api/query", "not json"),
    ("POST", "/api/query", {"question": "solar", "search_type": "bogus"}),
    ("POST", "/api/query", {"question": "solar", "filter": "title == "}),
    ("POST", "/api/query/stream", {"question": "solar", "filter": "((("}),
    ("POST", "/api/query/stream", "not json"),
    ("POST", "/api/query_async", {"question": "  "}),
    ("POST", "/api/transform/verbatim", {"question": "solar"}),
    ("POST", "/api/transform/verbatim", {"question": "solar", "context": [{"title": "no text"}]}),
    ("GET", "/api/query", None),
    ("GET", "/api/nope", None),
    ("OPTIONS", "/api/query", None),
    ("POST", "/api/debug/trace", {"action": "start"}),
]
CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods", "Access-Control-Allow-Headers", "Vary")


def _state(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def extractor_params():
    return init_highlighter_params(jax.random.PRNGKey(13), jax_tiny_config(**EXTRACTOR))


def _jax_extractor(params):
    return JaxExtractor(params=params, config=jax_tiny_config(**EXTRACTOR))


def _port_extractor(params):
    return ModelSpanExtractor(params=_state(params), config=tiny_test_config(**EXTRACTOR), device="cpu")


def _counted_ingest(index, docs):
    """Ingest with document and chunk ids from a counter, so both packages
    name their records alike."""
    counter = itertools.count()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        index.add_documents(docs)


@pytest.fixture(scope="module")
def rags(extractor_params):
    jax_index = JaxIndex(dense_provider=JaxDense(dim=64), sparse_provider=JaxSparse(), approx_topk=False)
    _counted_ingest(jax_index, [JaxSchema.from_file(str(p)) for p in DOCS])
    index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(dim=64), sparse_provider=HashedSparseProvider(), device="cpu"
    )
    _counted_ingest(index, [DocumentSchema.from_file(str(p)) for p in DOCS])
    return {
        "jax": JaxRAG(jax_index, extractor=_jax_extractor(extractor_params), k=K),
        "port": VerbatimRAG(index, extractor=_port_extractor(extractor_params), k=K),
    }


@pytest.fixture()
def servers(rags, extractor_params, monkeypatch):
    """Both packages' dependencies hold their RAG; the transform's offline
    extractor is the shared tiny one. Yields {tag: (app module, deps)}."""
    monkeypatch.delenv("API_DEBUG_TRACE", raising=False)
    mods = {"jax": (jax_app, jax_deps), "port": (app, deps)}
    offline = {"jax": lambda: _jax_extractor(extractor_params), "port": lambda: _port_extractor(extractor_params)}
    for tag, (app_mod, deps_mod) in mods.items():
        deps_mod.reset()
        deps_mod.set_rag(rags[tag])
        monkeypatch.setattr(app_mod, "_transform_cache", None)
        monkeypatch.setattr(app_mod, "_offline_extractor", offline[tag])
    yield mods
    for _, deps_mod in mods.values():
        deps_mod.reset()


async def _send(client, method, path, body, headers=None):
    kwargs = {"data": body} if isinstance(body, str) else {"json": body}
    resp = await client.request(method, path, headers=headers, **kwargs)
    text = await resp.text()
    return resp.status, text, {h: resp.headers.get(h) for h in CORS + ("Content-Type",)}


async def _both(servers, method, path, body, headers=None):
    out = {}
    for tag, (app_mod, _) in servers.items():
        async with TestClient(TestServer(app_mod.create_app(warmup=False))) as client:
            out[tag] = await _send(client, method, path, body, headers)
    return out


def assert_close(got, expected, where="body"):
    """Equal, except floats within RTOL/ATOL."""
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


def stream_events(text):
    """NDJSON events with the host-clock fields blanked (their names and the
    stages stay)."""
    events = [json.loads(line) for line in text.splitlines()]
    for event in events:
        if "elapsed_ms" in event:
            event["elapsed_ms"] = None
        for stage in event.get("timings", []):
            stage["elapsed_ms"] = None
    return events


def parse(text, content_type):
    if content_type and "ndjson" in content_type:
        return stream_events(text)
    if content_type and "json" in content_type:
        return json.loads(text)
    return text


@pytest.mark.parametrize("method,path,body", ROUTES, ids=[f"{m} {p} {i}" for i, (m, p, _) in enumerate(ROUTES)])
async def test_route_matches_jax(servers, method, path, body):
    out = await _both(servers, method, path, body)
    (status, text, headers), (j_status, j_text, j_headers) = out["port"], out["jax"]
    assert status == j_status
    assert headers == j_headers
    assert headers["Access-Control-Allow-Origin"] == "*"
    got = parse(text, headers["Content-Type"])
    if isinstance(got, dict) and "micro_batching" in got:
        _pop_queue_wait(got["micro_batching"])
    assert_close(got, parse(j_text, j_headers["Content-Type"]))


async def test_query_answers_are_verbatim_and_stream_in_order(servers):
    out = await _both(servers, "POST", "/api/query/stream", {"question": QUESTIONS[0]})
    events = stream_events(out["port"][1])
    assert [e["type"] for e in events] == ["documents", "progress", "highlights", "answer"]
    assert events[-1]["done"] and [t["stage"] for t in events[-1]["timings"]] == [
        "retrieve", "extract", "highlight", "template"
    ]
    docs = events[2]["data"]["documents"]
    assert any(d["highlights"] for d in docs)
    for d in docs:
        for h in d["highlights"]:
            assert d["content"][h["start"] : h["end"]] == h["text"]
    out = await _both(servers, "POST", "/api/query", {"question": QUESTIONS[0]})
    assert_close(json.loads(out["port"][1]), events[-1]["data"])


async def test_origin_echoed_when_allowlisted(servers, monkeypatch):
    monkeypatch.setenv("CORS_ORIGINS", "https://a.example, https://b.example")
    for _, deps_mod in servers.values():
        deps_mod._state.pop("config", None)
    for origin in ("https://b.example", "https://evil.example"):
        out = await _both(servers, "GET", "/api/status", None, headers={"Origin": origin})
        assert out["port"][2] == out["jax"][2]
    assert out["port"][2]["Vary"] == "Origin"


async def test_debug_trace_brackets_a_query(servers, monkeypatch, tmp_path):
    """With API_DEBUG_TRACE=1 both servers start and stop a trace around a
    query and answer alike, but for the device time of a CPU server: the
    JAX server sums the TPU planes of its CPU trace (0.0), the port reports
    none (null: not measured). The port writes a Chrome trace."""
    monkeypatch.setenv("API_DEBUG_TRACE", "1")
    bodies = {}
    for tag, (app_mod, _) in servers.items():
        logdir = str(tmp_path / tag)
        async with TestClient(TestServer(app_mod.create_app(warmup=False))) as client:
            started = await _send(client, "POST", "/api/debug/trace", {"action": "start", "logdir": logdir})
            await _send(client, "POST", "/api/query", {"question": QUESTIONS[0]})
            stopped = await _send(client, "POST", "/api/debug/trace", {"action": "stop"})
            bogus = await _send(client, "POST", "/api/debug/trace", {"action": "bogus"})
        bodies[tag] = [
            (s, json.loads(text.replace(logdir, "<logdir>"))) for s, text, _ in (started, stopped, bogus)
        ]
    assert bodies["port"][1][1].pop("module_wall_ms") is None
    assert bodies["jax"][1][1].pop("module_wall_ms") == 0.0
    spans, counters = bodies["port"][1][1].pop("spans"), bodies["port"][1][1].pop("counters")
    assert bodies["port"] == bodies["jax"]
    trace = json.loads((tmp_path / "port" / "trace.json").read_text())
    assert trace["traceEvents"]
    # The query ran in the micro-batcher's worker thread; its spans are in
    # the trace and in the stop response.
    annotated = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    stages = {"rag.query_batch", "rag.respond", "index.query_batch", "store.query_batch", "store.program",
              "store.readback", "store.materialize", "extract.plan", "extract.forward", "extract.decode"}
    assert {"vrag." + s for s in stages} <= annotated
    assert stages <= set(spans)
    assert spans["rag.query_batch"]["count"] == 1
    assert spans["rag.query_batch"]["total_ms"] >= spans["rag.query_batch"]["self_ms"] >= 0.0
    assert counters["rag.questions"] == 1 and counters["store.queries"] == 1
    assert counters["extract.rows"] >= 1


async def test_warmup_task_runs_on_startup(servers, caplog):
    """`create_app()` with its warm-up: the task builds the RAG in a thread,
    runs one query and logs no warning."""
    import logging

    with caplog.at_level(logging.INFO):
        application = app.create_app()
        async with TestClient(TestServer(application)) as client:
            await application["warmup_task"]
            status, _, _ = await _send(client, "GET", "/api/status", None)
    assert status == 200
    assert "warmup complete" in caplog.text
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]


async def test_concurrent_queries_coalesce_and_match_jax(servers):
    """Six concurrent `/api/query` calls with the same parameters run as
    fewer micro-batches than requests, and each answers as the JAX server
    answers the question alone."""
    questions = QUESTIONS * 2
    expected = []
    for q in questions:
        expected.append(json.loads((await _both({"jax": servers["jax"]}, "POST", "/api/query", {"question": q}))["jax"][1]))
    async with TestClient(TestServer(app.create_app(warmup=False))) as client:
        got = await asyncio.gather(*(_send(client, "POST", "/api/query", {"question": q}) for q in questions))
        stats = json.loads((await _send(client, "GET", "/api/status", None))[1])["micro_batching"]
    for (status, text, _), want in zip(got, expected):
        assert status == 200
        assert_close(json.loads(text), want)
    assert stats["requests"] == len(questions) and stats["batches"] < len(questions)


async def test_status_on_an_empty_server_from_env(monkeypatch, tmp_path):
    """No injected RAG: the server builds an empty hashed index on the
    device `VERBATIM_FORCE_PLATFORM` names, as the JAX server does."""
    monkeypatch.setenv("VERBATIM_FORCE_PLATFORM", "cpu")
    monkeypatch.setenv("INDEX_PATH", str(tmp_path / "missing"))
    deps.reset()
    try:
        async with TestClient(TestServer(app.create_app(warmup=False))) as client:
            status, text, _ = await _send(client, "GET", "/api/status", None)
        assert status == 200 and json.loads(text)["detail"] == "ready (empty index)"
        assert deps.get_index().device.type == "cpu" and deps.get_rag().extractor.device.type == "cpu"
    finally:
        deps.reset()


@pytest.mark.parametrize("value,expected", [("cpu", "cpu"), ("CPU", "cpu"), ("tpu", None), ("gpu", None)])
def test_platform_env_picks_the_device(monkeypatch, value, expected):
    monkeypatch.setenv("VERBATIM_FORCE_PLATFORM", value)
    if expected is None:
        with pytest.raises(ValueError, match="VERBATIM_FORCE_PLATFORM"):
            deps.device_from_env()
    else:
        assert deps.device_from_env().type == expected


@pytest.mark.parametrize("value", [None, "cuda"])
def test_platform_env_means_the_card_and_raises_without_one(monkeypatch, value):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if value is None:
        monkeypatch.delenv("VERBATIM_FORCE_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("VERBATIM_FORCE_PLATFORM", value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deps.device_from_env()


def test_server_loads_the_saved_index_on_its_device(rags, monkeypatch, tmp_path):
    """`INDEX_PATH` names a saved index: `get_index` loads it through the
    port's `VerbatimIndex.load` on the server's device, with the same rows."""
    path = str(tmp_path / "idx")
    rags["port"].index.save(path)
    monkeypatch.setenv("VERBATIM_FORCE_PLATFORM", "cpu")
    monkeypatch.setenv("INDEX_PATH", path)
    deps.reset()
    try:
        index = deps.get_index()
        assert index.device.type == "cpu"
        assert index.inspect() == rags["port"].index.inspect()
        got = [r.id for r in index.query(QUESTIONS[0], k=K)]
        assert got == [r.id for r in rags["port"].index.query(QUESTIONS[0], k=K)]
    finally:
        deps.reset()


# -- the micro-batcher, held to the JAX one --------------------------------------------

#: The port's micro-batcher statistics that the JAX one does not keep.
QUEUE_WAIT = ("queue_wait_ms", "queue_wait_max_ms")


def _pop_queue_wait(stats: dict) -> dict:
    """Take the port's queue-wait statistics out of ``stats`` (so the rest
    compares with the JAX batcher's) and check they are waits."""
    waits = {key: stats.pop(key) for key in QUEUE_WAIT}
    assert 0.0 <= waits["queue_wait_ms"] <= waits["queue_wait_max_ms"]
    return waits


async def _batched(module, arrivals, fail_on=None, max_batch=4):
    """Submit (question, params) pairs concurrently; record the batches."""
    seen = []

    def run_batch(questions, params):
        seen.append((list(questions), dict(params)))
        if fail_on is not None and fail_on in questions:
            raise ValueError(f"bad question {fail_on}")
        return [f"{q}|{params.get('k')}" for q in questions]

    batcher = module.MicroBatcher(run_batch, max_batch=max_batch, max_wait_ms=20.0)
    results = await asyncio.gather(
        *(batcher.submit(q, p) for q, p in arrivals), return_exceptions=True
    )
    return [r if isinstance(r, str) else repr(r) for r in results], sorted(seen, key=repr), batcher.stats()


ARRIVALS = {
    "same": [(f"q{i}", {"k": 3}) for i in range(6)],
    "split": [(f"q{i}", {"k": 3 if i % 2 else 5}) for i in range(6)],
    "filters": [("a", {"k": 3, "filter": {"x": 1}}), ("b", {"k": 3, "filter": {"x": 2}}), ("c", {"filter": {"x": 1}, "k": 3})],
}


@pytest.mark.parametrize("case", sorted(ARRIVALS))
async def test_micro_batcher_matches_jax(case):
    ours = await _batched(batching, ARRIVALS[case])
    theirs = await _batched(jax_batching, ARRIVALS[case])
    _pop_queue_wait(ours[2])
    assert ours == theirs
    results, seen, stats = ours
    assert stats["requests"] == len(ARRIVALS[case]) and stats["batches"] < len(ARRIVALS[case])
    for questions, params in seen:  # one parameter set a batch, at most max_batch questions
        assert len(questions) <= 4
        assert all(results[int(q[1:])].endswith(f"|{params.get('k')}") for q in questions if q[0] == "q")


async def test_micro_batcher_reports_how_long_requests_queued():
    """Three requests one a batch behind a run_batch that takes 50 ms: the
    first waits the gathering window (20 ms), the second and third also the
    runs before theirs."""
    import time as clock

    def run_batch(questions, params):
        clock.sleep(0.05)
        return list(questions)

    batcher = batching.MicroBatcher(run_batch, max_batch=1, max_wait_ms=20.0)
    assert batcher.stats()["queue_wait_ms"] == 0.0
    got = await asyncio.gather(*(batcher.submit(q, {"k": 3}) for q in ("a", "b", "c")))
    stats = batcher.stats()
    assert got == ["a", "b", "c"] and stats["batches"] == 3
    # Waits ≈ 20, 70 and 120 ms: mean ≈ 70, the longest ≈ 120.
    assert 100.0 <= stats["queue_wait_max_ms"] < 1000.0
    assert 60.0 <= stats["queue_wait_ms"] < stats["queue_wait_max_ms"]


async def test_micro_batch_failure_reaches_every_waiter_like_jax():
    ours = await _batched(batching, ARRIVALS["same"], fail_on="q1", max_batch=8)
    theirs = await _batched(jax_batching, ARRIVALS["same"], fail_on="q1", max_batch=8)
    _pop_queue_wait(ours[2])
    assert ours == theirs
    assert all("bad question q1" in r for r in ours[0])


@pytest.mark.parametrize("piece", [1000, 1 << 16, 1 << 20], ids=["1kB", "64KiB", "1MiB"])
async def test_chip_smoke_reads_stream_lines_longer_than_aiohttp_readline(piece):
    """A `highlights` event holds every retrieved chunk's text and can pass
    aiohttp's 128 KiB readline limit; the http phase of `chip_smoke.py`
    splits the NDJSON body itself, whatever pieces the socket delivers."""
    import chip_smoke
    from aiohttp import web
    from aiohttp.http_exceptions import LineTooLong

    events = [
        {"type": "documents", "data": [{"content": "short"}]},
        {"type": "highlights", "data": {"documents": [{"content": "word " * 60_000}]}},
        {"type": "answer", "data": {"answer": "done"}, "done": True},
    ]
    body = "".join(json.dumps(e) + "\n" for e in events).encode()

    async def handler(request):
        resp = web.StreamResponse(headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(request)
        for i in range(0, len(body), piece):
            await resp.write(body[i : i + piece])
        await resp.write_eof()
        return resp

    application = web.Application()
    application.router.add_get("/stream", handler)
    async with TestClient(TestServer(application)) as client:
        resp = await client.get("/stream")
        got = [json.loads(line) async for line in chip_smoke.ndjson_lines(resp.content) if line.strip()]
        resp = await client.get("/stream")
        with pytest.raises((LineTooLong, ValueError)):  # aiohttp 3.13.3 raises ValueError, 3.13.5 LineTooLong
            [line async for line in resp.content]
    assert got == events
