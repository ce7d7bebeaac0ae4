"""The port's LLM-backed branches against the JAX package's, with no network.

Both packages' `LLMClient`s talk to one `httpx.MockTransport` whose replies
are a pure function of the request (the prompt decides: span extraction,
structured extraction, intent classification or a template draft), so two
clients that send the same requests get the same replies. Held equal, with
the requests each side sent: the client's calls and retry rules, the
prompted `LLMSpanExtractor`, contextual templates, `extract_structured` and
structured mode, the intent short-circuits of `query`, `query_batch`,
`query_async` and the stream, `VerbatimTransform`, the API's transform
route with an LLM, and the CLI's ``query --llm``.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import re
import types
import uuid
from pathlib import Path

import httpx
import pytest

from verbatim_rag_tpu.core import llm_client as jax_llm
from verbatim_rag_tpu.core import transform as jax_transform
from verbatim_rag_tpu.core.extractors import LLMSpanExtractor as JaxLLMExtractor
from verbatim_rag_tpu.core.templates import TemplateManager as JaxTemplateManager
from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine.embedding_providers import HashedBowDenseProvider as JaxDense
from verbatim_rag_tpu.engine.embedding_providers import HashedSparseProvider as JaxSparse
from verbatim_rag_tpu.engine.search_result import SearchResult as JaxSearchResult
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.rag import StreamingRAG as JaxStreamingRAG
from verbatim_rag_tpu.rag import VerbatimRAG as JaxRAG
from verbatim_rag_tpu.rag import cli as jax_cli
from verbatim_rag_tpu.rag import intent as jax_intent
from verbatim_rag_tpu_torch.core import llm_client
from verbatim_rag_tpu_torch.core import transform
from verbatim_rag_tpu_torch.core.extractors import LLMSpanExtractor
from verbatim_rag_tpu_torch.core.providers import RAGProvider
from verbatim_rag_tpu_torch.core.templates import TemplateManager
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.engine.search_result import SearchResult
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.rag import StreamingRAG, VerbatimRAG, cli, intent

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))
K = 3
QUESTIONS = [
    "How efficient are solar panels?",
    "hello there",
    "Where do offshore wind farms get steadier wind?",
    "what is the stock price today",
    "will the weather be nice",
]
TEXTS = [
    "Solar panels convert sunlight into electricity. Modern panels reach about 22% efficiency.",
    "Offshore wind farms see steadier winds. Turbines there are larger.",
    "Batteries store daytime solar energy for use at night.",
    "Grid operators balance supply and demand every second.",
    "Heat pumps move heat instead of making it.",
    "Hydropower stores energy by pumping water uphill.",
    "Geothermal plants tap the heat of the earth's crust.",
]
STRUCTURED = "Method: [METHODOLOGY]\n\nFindings: [RESULTS]"


# -- the mock endpoint ------------------------------------------------------------------


def first_sentence(text: str) -> str:
    end = text.find(". ")
    return text[: end + 1] if end >= 0 else text[:80]


def reply(payload: dict) -> str:
    """The mock LLM's answer: a pure function of the request body."""
    prompt = payload["messages"][-1]["content"]
    if prompt.startswith("Classify the user question"):
        question = prompt.split("Question: ", 1)[1].split("\n", 1)[0].lower()
        if "hello" in question:
            return json.dumps({"intent": "greeting", "confidence": 0.9, "reason": "greets"})
        if "stock" in question:
            return json.dumps({"intent": "offtopic", "confidence": 0.8, "reason": "finance"})
        if "weather" in question:
            return json.dumps({"intent": "offtopic", "confidence": 0.3, "reason": "unsure"})
        return json.dumps({"intent": "default", "confidence": 0.95, "reason": "retrieval"})
    if "Placeholders and what each should capture" in prompt:
        names = re.findall(r"^- ([A-Z_]+): ", prompt, re.M)
        docs = re.findall(r"\[Document (\d+)\]\n(.*?)(?=\n\n---\n\n\[Document|\Z)", prompt, re.S)
        out = {}
        for j, name in enumerate(names):
            i, text = docs[j % len(docs)]
            out[name] = [
                {"text": first_sentence(text), "doc": int(i)},
                {"text": "words the documents never say", "doc": 0},
                {"text": first_sentence(text), "doc": 99},
                first_sentence(docs[0][1]),
            ]
        return json.dumps(out)
    if prompt.startswith("CUSTOM"):
        docs = dict(re.findall(r"\[(doc_\d+)\]\n(.*?)(?=\n\n\[doc_|\Z)", prompt, re.S))
        return json.dumps({k: [first_sentence(v)] for k, v in docs.items()})
    if "Documents:\n" in prompt and prompt.rstrip().endswith("JSON:"):
        docs = json.loads(prompt.split("Documents:\n", 1)[1].rsplit("\n\nJSON:", 1)[0])
        return json.dumps({
            k: [first_sentence(v), first_sentence(v).upper(), "not in the text at all"] for k, v in docs.items()
        })
    if prompt.startswith("Write ") and "distinct response templates" in prompt:
        return json.dumps({"templates": ["Quotes:\n\n[DISPLAY_SPANS]", 7, "Sources:\n\n[DISPLAY_SPANS]\n\n[CITATION_REFS]"]})
    if "Use each of [SPAN_1]" in prompt:
        n = int(re.search(r"Number of verbatim quotes shown in full: (\d+)", prompt).group(1))
        body = "\n".join(f"- **Point {i}**: [SPAN_{i}]" for i in range(1, n + 1))
        return f"Here is what the sources say.\n\n{body}\n\n[CITATION_REFS]"
    return "The sources answer this directly.\n\n## Relevant Quotes\n\n[DISPLAY_SPANS]"


class Endpoint:
    """A mock `/chat/completions` that logs every request it is sent.

    ``fail``: (predicate on the prompt, status, times) — answer that status
    instead, at most ``times`` times."""

    def __init__(self, fail=None):
        self.requests = []
        self.fail = fail

    def __call__(self, request: httpx.Request) -> httpx.Response:
        payload = json.loads(request.content)
        self.requests.append(
            (request.method, str(request.url), request.headers["authorization"], payload)
        )
        if self.fail is not None:
            match, status, times = self.fail
            if times > 0 and match(payload["messages"][-1]["content"]):
                self.fail = (match, status, times - 1)
                if status == "connect":
                    raise httpx.ConnectError("refused", request=request)
                return httpx.Response(status, headers={"Retry-After": "0.25"}, json={"error": "x"})
        content = reply(payload)
        return httpx.Response(200, json={"choices": [{"message": {"role": "assistant", "content": content}}]})


def mocked(module, endpoint: Endpoint, **kwargs):
    client = module.LLMClient(model="test-model", api_key="test-key", **kwargs)
    transport = httpx.MockTransport(endpoint)
    client._client = httpx.Client(transport=transport)
    client._async_client = httpx.AsyncClient(transport=transport)
    return client


def pair(fail=None, **kwargs):
    """{tag: (client, endpoint)} for the port and JAX, each its own log."""
    out = {}
    for tag, module in (("port", llm_client), ("jax", jax_llm)):
        endpoint = Endpoint(fail)
        out[tag] = (mocked(module, endpoint, **kwargs), endpoint)
    return out


def results_of(cls, texts):
    return [cls(id=f"r{i}", text=t, metadata={"title": f"t{i}"}) for i, t in enumerate(texts)]


# -- the client -------------------------------------------------------------------------

CALLS = {
    "complete": ("complete", ("hi",), {}),
    "complete_json_system": ("complete", ("hi",), dict(json_mode=True, temperature=0.1, system_prompt="sys")),
    "extract_spans": ("extract_spans", (QUESTIONS[0], {"doc_0": TEXTS[0], "doc_1": TEXTS[1]}), {}),
    "extract_relevant_spans": ("extract_relevant_spans", (QUESTIONS[0], TEXTS[0]), {}),
    "extract_structured": (
        "extract_structured", (QUESTIONS[0], STRUCTURED, {"METHODOLOGY": "how", "RESULTS": "what"}, TEXTS[:3]), {}
    ),
    "template_per_fact": ("generate_template", (QUESTIONS[0], TEXTS[:3], 1), {}),
    "template_aggregate": ("generate_template", (QUESTIONS[0], TEXTS * 2, 0), {}),
    "template_raw_spans": (
        "generate_template", (QUESTIONS[0], ["a\nb", "c"], 2),
        dict(preview_chars=None, preserve_span_newlines=True, system_prompt="be brief"),
    ),
    "template_custom_prompt": (
        "generate_template", (QUESTIONS[0], TEXTS[:2], 0), dict(template_prompt="Q: {{ question }} n={{ n_spans }}")
    ),
    "template_pool": ("generate_template_pool", ("solar", 3), {}),
    "complete_async": ("complete_async", ("hi",), dict(json_mode=True)),
    "extract_spans_async": ("extract_spans_async", (QUESTIONS[2], {"doc_0": TEXTS[1]}), {}),
    "extract_relevant_spans_async": ("extract_relevant_spans_async", (QUESTIONS[0], TEXTS[2]), {}),
    "extract_structured_async": (
        "extract_structured_async", (QUESTIONS[0], STRUCTURED, {"METHODOLOGY": "how", "RESULTS": "what"}, TEXTS[:2]), {}
    ),
    "template_async": ("generate_template_async", (QUESTIONS[0], TEXTS[:2], 0), {}),
}


def call(client, name, args, kwargs):
    out = getattr(client, name)(*args, **kwargs)
    return asyncio.run(out) if asyncio.iscoroutine(out) else out


@pytest.mark.parametrize("case", sorted(CALLS))
def test_client_calls_match_jax(case):
    name, args, kwargs = CALLS[case]
    clients = pair()
    got = {tag: call(client, name, args, kwargs) for tag, (client, _) in clients.items()}
    assert got["port"] == got["jax"]
    assert clients["port"][1].requests == clients["jax"][1].requests
    method, url, auth, payload = clients["port"][1].requests[0]
    assert (method, url, auth) == ("POST", "https://api.openai.com/v1/chat/completions", "Bearer test-key")
    assert payload["model"] == "test-model"


FAILURES = {
    "429_then_ok": (lambda p: True, 429, 1),
    "503_twice_then_ok": (lambda p: True, 503, 2),
    "500_always": (lambda p: True, 500, 9),
    "400_not_retried": (lambda p: True, 400, 9),
    "connect_error": (lambda p: True, "connect", 1),
}


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("case", sorted(FAILURES))
def test_retry_rules_match_jax(case, asynchronous, monkeypatch):
    """Transport errors and 408/429/5xx retry with the same delays
    (Retry-After first, else exponential backoff); other 4xx raise at once."""
    clients = pair(fail=FAILURES[case], max_retries=2)
    outcome = {}
    for tag, module in (("port", llm_client), ("jax", jax_llm)):
        delays = []

        async def asleep(s, delays=delays):
            delays.append(s)

        monkeypatch.setattr(module, "time", types.SimpleNamespace(sleep=delays.append))
        monkeypatch.setattr(module, "asyncio", types.SimpleNamespace(sleep=asleep))
        client, endpoint = clients[tag]
        try:
            result = call(client, "complete_async" if asynchronous else "complete", ("hi",), {})
        except (httpx.HTTPStatusError, httpx.TransportError) as exc:
            result = type(exc).__name__
        outcome[tag] = (result, delays, len(endpoint.requests))
    assert outcome["port"] == outcome["jax"]


@pytest.mark.parametrize("content", ["not json", "[1, 2]", '{"doc_0": ["Solar panels"]}'])
def test_lax_json_replies_match_jax(content):
    got = {}
    for tag, module in (("port", llm_client), ("jax", jax_llm)):
        client = module.LLMClient(api_key="k")
        transport = httpx.MockTransport(
            lambda r: httpx.Response(200, json={"choices": [{"message": {"content": content}}]})
        )
        client._client = httpx.Client(transport=transport)
        got[tag] = (
            client.extract_spans("q", {"doc_0": TEXTS[0]}),
            client.extract_structured("q", STRUCTURED, {"METHODOLOGY": "how"}, TEXTS[:1]),
        )
    assert got["port"] == got["jax"]


# -- the prompted extractor -------------------------------------------------------------

EXTRACTORS = {
    "auto_batch": dict(),
    "auto_individual": dict(batch_size=2),
    "batch_chunks": dict(extraction_mode="batch", batch_size=3),
    "individual": dict(extraction_mode="individual"),
    "fuzzy": dict(span_match_mode="fuzzy", fuzzy_threshold=0.9),
    "custom_prompt": dict(extraction_prompt="CUSTOM {{ question }}\n\n{{ documents }}", system_prompt="sys"),
}


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("case", sorted(EXTRACTORS))
def test_llm_span_extractor_matches_jax(case, asynchronous):
    clients = pair()
    spans = {}
    for tag, cls, result_cls in (("port", LLMSpanExtractor, SearchResult), ("jax", JaxLLMExtractor, JaxSearchResult)):
        extractor = cls(llm_client=clients[tag][0], **EXTRACTORS[case])
        results = results_of(result_cls, TEXTS)
        if asynchronous:
            spans[tag] = asyncio.run(extractor.extract_spans_async(QUESTIONS[0], results))
        else:
            spans[tag] = extractor.extract_spans(QUESTIONS[0], results)
    assert spans["port"] == spans["jax"]
    assert clients["port"][1].requests == clients["jax"][1].requests
    for text, found in spans["port"].items():
        assert found and all(s in text for s in found)


@pytest.mark.parametrize("asynchronous", [False, True])
def test_batch_failure_falls_back_to_single_calls_like_jax(asynchronous):
    """A failing batch call is retried document by document."""
    batch = (lambda p: '"doc_1"' in p, 500, 9)
    clients = pair(fail=batch, max_retries=0)
    spans = {}
    for tag, cls, result_cls in (("port", LLMSpanExtractor, SearchResult), ("jax", JaxLLMExtractor, JaxSearchResult)):
        extractor = cls(llm_client=clients[tag][0], extraction_mode="batch")
        results = results_of(result_cls, TEXTS[:3])
        run = extractor.extract_spans_async if asynchronous else extractor.extract_spans
        out = run(QUESTIONS[0], results)
        spans[tag] = asyncio.run(out) if asynchronous else out
    assert spans["port"] == spans["jax"]
    assert clients["port"][1].requests == clients["jax"][1].requests
    assert len(clients["port"][1].requests) == 4


def test_extractor_rejects_bad_modes_like_jax():
    for kwargs in (dict(span_match_mode="loose"), dict(extraction_mode="all")):
        with pytest.raises(ValueError) as ours:
            LLMSpanExtractor(llm_client=object(), **kwargs)
        with pytest.raises(ValueError) as theirs:
            JaxLLMExtractor(llm_client=object(), **kwargs)
        assert str(ours.value) == str(theirs.value)


# -- templates --------------------------------------------------------------------------


@pytest.mark.parametrize("n_display,n_citation", [(3, 0), (3, 2), (9, 0)])
@pytest.mark.parametrize("asynchronous", [False, True])
def test_contextual_templates_match_jax(n_display, n_citation, asynchronous):
    clients = pair()
    display = [{"text": t, "doc_text": t} for t in (TEXTS * 2)[:n_display]]
    citation = [{"text": t, "doc_text": t} for t in TEXTS[:n_citation]]
    answers = {}
    for tag, cls in (("port", TemplateManager), ("jax", JaxTemplateManager)):
        tm = cls(llm_client=clients[tag][0], default_mode="contextual")
        run = tm.process_async if asynchronous else tm.process
        out = run(QUESTIONS[0], display, citation)
        answers[tag] = asyncio.run(out) if asynchronous else out
        answers[tag] = (answers[tag], tm.info())
    assert answers["port"] == answers["jax"]
    assert clients["port"][1].requests == clients["jax"][1].requests
    assert "[SPAN_" not in answers["port"][0] and TEXTS[0] in answers["port"][0]


# -- VerbatimRAG with an LLM: default extractor, structured mode, intent -------------------


def _counted_ingest(index, docs):
    counter = itertools.count()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        index.add_documents(docs)


@pytest.fixture(scope="module")
def indexes():
    jax_index = JaxIndex(dense_provider=JaxDense(dim=64), sparse_provider=JaxSparse(), approx_topk=False)
    _counted_ingest(jax_index, [JaxSchema.from_file(str(p)) for p in DOCS])
    index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(dim=64), sparse_provider=HashedSparseProvider(), device="cpu"
    )
    _counted_ingest(index, [DocumentSchema.from_file(str(p)) for p in DOCS])
    return {"port": index, "jax": jax_index}


def _intents(module):
    return module.LLMIntentDetector(
        None,
        intents=[
            module.IntentSpec("greeting", ["hello", "hi"], route="predefined", answer="Hi! Ask me about energy."),
            module.IntentSpec("offtopic", ["stock prices"], route="skip", description="not about energy"),
        ],
    )


def rags(indexes, structured=False, intents=False, **kwargs):
    """{tag: (rag, endpoint)}: each package's VerbatimRAG over its own LLM
    client (so its own request log)."""
    clients = pair()
    out = {}
    for tag, rag_cls, tm_cls, mod in (
        ("port", VerbatimRAG, TemplateManager, intent), ("jax", JaxRAG, JaxTemplateManager, jax_intent)
    ):
        client, endpoint = clients[tag]
        detector = None
        if intents:
            detector = _intents(mod)
            detector.llm_client = client
        tm = None
        if structured:
            tm = tm_cls(llm_client=client, default_mode="contextual")
            tm.strategies["structured"].set_template(STRUCTURED)
        out[tag] = (
            rag_cls(indexes[tag], llm_client=client, template_manager=tm, intent_detector=detector, k=K, **kwargs),
            endpoint,
        )
    return out


def view(response):
    data = response.model_dump()
    for d in data["documents"]:
        d["metadata"].pop("score", None)
    return data


ENTRIES = ["query", "query_async", "query_batch"]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("mode", ["default", "structured", "intent"])
def test_rag_with_an_llm_matches_jax(indexes, entry, mode):
    """The LLM extractor and contextual templates by default; structured
    mode (per-placeholder extraction, each span verified against the document
    it names); intent short-circuits at their positions in a batch."""
    pairs = rags(indexes, structured=mode == "structured", intents=mode == "intent")
    template_mode = "structured" if mode == "structured" else None
    got = {}
    for tag, (rag, endpoint) in pairs.items():
        if entry == "query_batch":
            responses = rag.query_batch(QUESTIONS, template_mode=template_mode)
        elif entry == "query_async":
            async def gather(rag=rag):
                return [await rag.query_async(q, template_mode=template_mode) for q in QUESTIONS]

            responses = asyncio.run(gather())
        else:
            responses = [rag.query(q, template_mode=template_mode) for q in QUESTIONS]
        got[tag] = [view(r) for r in responses]
    assert got["port"] == got["jax"]
    assert pairs["port"][1].requests == pairs["jax"][1].requests
    answers = [r["answer"] for r in got["port"]]
    if mode == "intent":
        assert answers[1] == "Hi! Ask me about energy." and answers[3] == "I can't help with that request."
        assert got["port"][1]["documents"] == [] and got["port"][4]["documents"]
    if mode == "structured":
        assert answers[0].startswith("Method: ") and "[METHODOLOGY]" not in answers[0]
    for r in got["port"]:
        for d in r["documents"]:
            for h in d["highlights"]:
                assert d["content"][h["start"] : h["end"]] == h["text"]


def test_structured_mode_needs_an_llm_like_jax(indexes):
    for tag, rag_cls, tm_cls in (("port", VerbatimRAG, TemplateManager), ("jax", JaxRAG, JaxTemplateManager)):
        rag = rag_cls(indexes[tag], extractor=object(), template_manager=tm_cls(default_mode="structured"))
        with pytest.raises(ValueError, match="requires an LLM client"):
            rag.query(QUESTIONS[0])


def test_stream_short_circuits_and_answers_like_jax(indexes):
    pairs = rags(indexes, intents=True)
    events = {}
    for tag, stream_cls in (("port", StreamingRAG), ("jax", JaxStreamingRAG)):
        rag, _ = pairs[tag]
        events[tag] = [stream_cls(rag).stream_query_sync(q) for q in QUESTIONS]
        for per_question in events[tag]:
            for event in per_question:
                event.pop("elapsed_ms", None)
                for stage in event.get("timings", []):
                    stage.pop("elapsed_ms")
    assert events["port"] == events["jax"]
    assert pairs["port"][1].requests == pairs["jax"][1].requests
    assert [e["type"] for e in events["port"][1]] == ["answer"]
    assert [e["type"] for e in events["port"][0]] == ["documents", "progress", "highlights", "answer"]


def test_intent_detector_routes_like_jax():
    clients = pair()
    decisions = {}
    for tag, mod in (("port", intent), ("jax", jax_intent)):
        detector = _intents(mod)
        detector.llm_client = clients[tag][0]
        decisions[tag] = [vars(detector.detect(q)) for q in QUESTIONS]
        broken = mod.LLMIntentDetector(types.SimpleNamespace(complete=lambda *a, **k: "not json"))
        decisions[tag].append(vars(broken.detect("q")))
    assert decisions["port"] == decisions["jax"]
    assert [d["route"] for d in decisions["port"]] == ["continue", "predefined", "continue", "skip", "continue", "continue"]


# -- the stateless transform ------------------------------------------------------------


class _Provider(RAGProvider):
    def retrieve(self, question, k=5, filter=None):
        return [{"content": t, "title": f"t{i}"} for i, t in enumerate(TEXTS[:k])]


CONTEXTS = {
    "dicts": [{"content": TEXTS[0], "title": "a", "source": "s"}, {"text": TEXTS[1], "metadata": {"x": 1}}],
    "strings": TEXTS[:4],
    "results": "search_results",
}


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("case", sorted(CONTEXTS))
def test_verbatim_transform_matches_jax(case, asynchronous):
    clients = pair()
    got = {}
    for tag, mod, result_cls in (("port", transform, SearchResult), ("jax", jax_transform, JaxSearchResult)):
        context = CONTEXTS[case] if case != "results" else results_of(result_cls, TEXTS[:3])
        vt = mod.VerbatimTransform(llm_client=clients[tag][0], max_display_spans=2)
        run = vt.transform_async if asynchronous else vt.transform
        out = run(QUESTIONS[0], context)
        got[tag] = (asyncio.run(out) if asynchronous else out).model_dump()
    assert got["port"] == got["jax"]
    assert clients["port"][1].requests == clients["jax"][1].requests
    assert got["port"]["structured_answer"]["citations"]


def test_verbatim_query_through_a_provider_matches_jax(monkeypatch):
    """`verbatim_query` builds its own client: both packages' clients get the
    mock transport."""
    endpoint = Endpoint()
    for module in (llm_client, jax_llm):
        monkeypatch.setattr(module.LLMClient, "_sync_client", lambda self: httpx.Client(transport=httpx.MockTransport(endpoint)))
    ours = transform.verbatim_query(_Provider(), QUESTIONS[0], k=3).model_dump()
    port_requests = list(endpoint.requests)
    endpoint.requests.clear()

    class JaxProvider(jax_transform.RAGProvider):
        retrieve = _Provider.retrieve

    theirs = jax_transform.verbatim_query(JaxProvider(), QUESTIONS[0], k=3).model_dump()
    assert ours == theirs and port_requests == endpoint.requests


def test_normalize_context_matches_jax():
    items = [*CONTEXTS["dicts"], "plain", JaxSearchResult(id="x", text="obj text", metadata={"m": 1})]
    assert [vars(c) for c in transform.normalize_context(items)] == [
        vars(c) for c in jax_transform.normalize_context(items)
    ]
    for bad in ([{"title": "no body"}], [3]):
        with pytest.raises((ValueError, TypeError)) as ours:
            transform.normalize_context(bad)
        with pytest.raises((ValueError, TypeError)) as theirs:
            jax_transform.normalize_context(bad)
        assert (type(ours.value), str(ours.value)) == (type(theirs.value), str(theirs.value))


# -- the API's transform route with an LLM ----------------------------------------------


async def test_transform_route_with_an_llm_matches_jax(monkeypatch):
    """`LLM_MODEL` set: the route's cached transform is the LLM pipeline
    (prompted extractor, contextual templates), as in the JAX server."""
    from aiohttp.test_utils import TestClient, TestServer

    from verbatim_rag_tpu.api import app as jax_app
    from verbatim_rag_tpu.api import dependencies as jax_deps
    from verbatim_rag_tpu_torch.api import app
    from verbatim_rag_tpu_torch.api import dependencies as deps

    monkeypatch.setenv("LLM_MODEL", "test-model")
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    endpoint = Endpoint()
    body = {"question": QUESTIONS[0], "context": CONTEXTS["dicts"]}
    got = {}
    for tag, app_mod, deps_mod, module in (("port", app, deps, llm_client), ("jax", jax_app, jax_deps, jax_llm)):
        monkeypatch.setattr(
            module.LLMClient, "_get_async_client",
            lambda self: httpx.AsyncClient(transport=httpx.MockTransport(endpoint)),
        )
        monkeypatch.setattr(app_mod, "_transform_cache", None)
        deps_mod.reset()
        try:
            async with TestClient(TestServer(app_mod.create_app(warmup=False))) as client:
                resp = await client.post("/api/transform/verbatim", json=body)
                got[tag] = (resp.status, await resp.json(), list(endpoint.requests))
        finally:
            deps_mod.reset()
        endpoint.requests.clear()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 200 and got["port"][2]


# -- the CLI's query --llm --------------------------------------------------------------


def test_cli_query_with_llm_matches_jax(tmp_path, monkeypatch, capsys):
    """``query --llm --model m --api-base b`` sends the same requests to
    ``b`` and prints and writes what the JAX CLI does."""
    monkeypatch.chdir(tmp_path)
    endpoint = Endpoint()
    outputs = {}
    for tag, main, module, device in (
        ("jax", jax_cli.main, jax_llm, []), ("port", cli.main, llm_client, ["--device", "cpu"])
    ):
        monkeypatch.setattr(
            module.LLMClient, "_sync_client", lambda self: httpx.Client(transport=httpx.MockTransport(endpoint))
        )
        counter = itertools.count()
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter)))
        assert main(["index", str(DOCS[0].parent), "--db", f"{tag}/idx", "--sparse", *device]) == 0
        capsys.readouterr()
        argv = ["query", QUESTIONS[0], "--db", f"{tag}/idx", "--llm", "--model", "m-1",
                "--api-base", "http://llm.invalid/v1/", "--json", f"{tag}.json", *device]
        assert main(argv) == 0
        outputs[tag] = (
            capsys.readouterr().out.replace(f"{tag}.json", "<json>"),
            json.load(open(f"{tag}.json")),
            list(endpoint.requests),
        )
        endpoint.requests.clear()
    assert outputs["port"] == outputs["jax"]
    out, response, requests = outputs["port"]
    assert requests and all(url == "http://llm.invalid/v1/chat/completions" for _, url, _, _ in requests)
    assert {p["model"] for *_, p in requests} == {"m-1"}
    assert response["structured_answer"]["citations"]
