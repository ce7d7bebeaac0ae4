"""VerbatimDOC, the RAG provider adapters, `verbatim_enhance` and the
`verbatim-enhance` CLI of the PyTorch port against the JAX package's.

Every case runs the same inputs through both packages and compares the
results exactly (text, spans, citations, stream events, the calls each RAG
received). The unit cases mirror `tests/test_core_extras.py`'s
(`TestVerbatimDocVariants`, `TestVerbatimDocMalformedParams`,
`TestEnhanceDecoratorShapes`, `TestCliRecordIterBom`) over fake RAG objects
built from each package's own response models; the pipeline cases run each
package's `VerbatimRAG` over the hashed providers (exact selection) with a
prompted extractor whose LLM is one `httpx.MockTransport` (a pure function
of the prompt: each document's first sentence), so no request leaves the
process.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import uuid
from pathlib import Path
from unittest import mock
from unittest.mock import MagicMock

import httpx
import pytest

from verbatim_rag_tpu.core import cli as jax_cli
from verbatim_rag_tpu.core import llm_client as jax_llm
from verbatim_rag_tpu.core import models as jax_models
from verbatim_rag_tpu.core.enhance import verbatim_enhance as jax_enhance
from verbatim_rag_tpu.core.templates import TemplateManager as JaxTemplateManager
from verbatim_rag_tpu.core.transform import VerbatimTransform as JaxTransform
from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine.embedding_providers import HashedBowDenseProvider as JaxDense
from verbatim_rag_tpu.engine.embedding_providers import HashedSparseProvider as JaxSparse
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.rag import VerbatimRAG as JaxRAG
from verbatim_rag_tpu.rag import providers as jax_providers
from verbatim_rag_tpu.rag import verbatim_doc as jax_doc
from verbatim_rag_tpu_torch.core import cli
from verbatim_rag_tpu_torch.core import llm_client
from verbatim_rag_tpu_torch.core import models
from verbatim_rag_tpu_torch.core.enhance import verbatim_enhance
from verbatim_rag_tpu_torch.core.templates import TemplateManager
from verbatim_rag_tpu_torch.core.transform import VerbatimTransform
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.rag import VerbatimRAG
from verbatim_rag_tpu_torch.rag import providers
from verbatim_rag_tpu_torch.rag import verbatim_doc

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))
SIDES = {"port": (verbatim_doc, models), "jax": (jax_doc, jax_models)}

REPORT = """# Energy report

Intro text [!query=How efficient are solar panels?] and more.

## Solar

[!query=What limits photovoltaic output?|format=bullet]

[!query=How is solar energy stored?|k=2,format=short]

## Wind

Offshore: [!query=Why is offshore wind steadier?|max_length=60]
[!query=How large are turbines?|k=2]
[!query=wind|k=2,format=bullet,max_length=30]
"""


# -- fake RAG objects, one set per package ------------------------------------------


def _response(m, question, spans, title="Doc"):
    return m.QueryResponse(
        question=question,
        answer=f"answer to {question}",
        structured_answer=m.StructuredAnswer(text="a"),
        documents=[
            m.DocumentWithHighlights(
                content=f"context for {question}: " + " ".join(spans),
                title=title,
                highlights=[m.Highlight(text=s, start=0, end=len(s)) for s in spans],
            )
        ],
    )


class BatchRag:
    """A RAG whose `query_batch` works, logging every call."""

    def __init__(self, m):
        self.m = m
        self.batch_calls = []
        self.single_calls = []

    def _answer(self, q):
        return _response(self.m, q, [f"span:{q}", "shared span"])

    def query(self, question, k=5, **kw):
        self.single_calls.append((question, k))
        return self._answer(question)

    def query_batch(self, questions, k=5, **kw):
        self.batch_calls.append((list(questions), k))
        return [self._answer(q) for q in questions]


def _mock_rag(m):
    rag = MagicMock()
    rag.query.return_value = _response(m, "q", ["alpha beta"])
    return rag


def _dump(resp):
    return dict(
        document=resp.document,
        citations=resp.citations,
        queries=[
            (r.query.text, r.query.params, r.query.start, r.query.end, r.query.section,
             r.spans, r.answer_text, r.error)
            for r in resp.queries
        ],
    )


def _both(run):
    """``run(doc_module, models_module)`` on each package: {side: result}."""
    return {side: run(mod, m) for side, (mod, m) in SIDES.items()}


# -- the parser, the processor and the splice ----------------------------------------


@pytest.mark.parametrize(
    "document",
    [
        REPORT,
        "no directives at all",
        "[!query=a|k=3] [!query=b] [!query=c|k=3]",
        "x [!query=first] y [!query=second|format=bullet,flag=true,n=7] z",
        "# H1\n## H2 [!query=on the header line]\n[!query=after|junk,k=1]",
    ],
)
def test_parser_matches_jax(document):
    got = _both(lambda mod, m: [vars(q) for q in mod.Parser.parse(document)])
    assert got["port"] == got["jax"]


def test_process_batches_by_k_like_jax():
    """Directives grouped by their ``k``: one `query_batch` a group, the
    splice and global numbering (a span shared by every query is one
    citation) equal to JAX's."""
    def run(mod, m):
        rag = BatchRag(m)
        return _dump(mod.VerbatimDOC(rag).process(REPORT)), rag.batch_calls, rag.single_calls

    got = _both(run)
    assert got["port"] == got["jax"]
    _, batch_calls, single_calls = got["port"]
    assert [k for _, k in batch_calls] == [5, 2] and single_calls == []
    assert sum(len(qs) for qs, _ in batch_calls) == 6


def test_interactive_veto_matches_jax():
    doc = "x [!query=first] y [!query=second] z"

    def run(mod, m):
        return _dump(mod.VerbatimDOC(_mock_rag(m)).process_interactive(
            doc, approve=lambda r: r.query.text == "first"
        ))

    got = _both(run)
    assert got["port"] == got["jax"]
    assert "[!query=second]" in got["port"]["document"]


def test_stream_process_events_match_jax():
    async def collect(mod, m):
        return [e async for e in mod.VerbatimDOC(BatchRag(m)).stream_process(REPORT)]

    got = _both(lambda mod, m: asyncio.run(collect(mod, m)))
    assert got["port"] == got["jax"]
    types = [e["type"] for e in got["port"]]
    assert types[0] == "start" and types[-1] == "done" and types.count("query_complete") == 6


def test_citation_dedup_across_queries_like_jax():
    doc = "first: [!query=a]\nsecond: [!query=b]"
    got = _both(lambda mod, m: _dump(mod.VerbatimDOC(_mock_rag(m)).process(doc)))
    assert got["port"] == got["jax"]
    assert len(got["port"]["citations"]) == 1 and got["port"]["document"].count("[1]") == 2


@pytest.mark.parametrize(
    "case",
    ["batch_failure", "right_length_garbage", "short_batch", "mock_rag", "malformed_k"],
)
def test_batch_fallbacks_match_jax(case):
    """A failing, garbage-returning or short `query_batch`, a bare MagicMock
    RAG and a malformed ``k``: each query degrades on its own, as in JAX."""
    doc = "[!query=a|k=five] [!query=b] [!query=c]" if case == "malformed_k" else "[!query=a] [!query=b]"

    def run(mod, m):
        if case == "mock_rag":
            return _dump(mod.VerbatimDOC(_mock_rag(m)).process(doc)), None, None
        rag = BatchRag(m)
        if case == "batch_failure":
            rag.query_batch = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
        elif case == "right_length_garbage":
            rag.query_batch = lambda questions, **kw: ["not a response"] * len(questions)
        elif case == "short_batch":
            rag.query_batch = lambda questions, **kw: [rag._answer(questions[0])]
        return _dump(mod.VerbatimDOC(rag).process(doc)), rag.batch_calls, rag.single_calls

    got = _both(run)
    assert got["port"] == got["jax"]
    if case == "malformed_k":
        assert got["port"][1] == [(["b", "c"], 5)]
    elif case != "mock_rag":
        assert [q for q, _ in got["port"][2]] == ["a", "b"]


@pytest.mark.parametrize("max_length", ["20.5", "4", "0", "x"])
def test_malformed_and_valid_max_length_match_jax(max_length):
    doc = f"intro [!query=results|max_length={max_length}] outro"
    got = _both(lambda mod, m: _dump(mod.VerbatimDOC(_mock_rag(m)).process(doc)))
    assert got["port"] == got["jax"]
    assert "[!query" not in got["port"]["document"]


@pytest.mark.parametrize(
    "params",
    [{}, {"format": "bullet"}, {"format": "short"}, {"max_length": 7}, {"format": "bullet", "max_length": 12}],
)
def test_format_spans_matches_jax(params):
    spans = [{"text": t, "doc_title": "d", "doc_index": 0} for t in ("one two three", "four", "five six")]
    assert verbatim_doc._format_spans(spans, params) == jax_doc._format_spans(spans, params)
    assert verbatim_doc._format_spans([], params) == jax_doc._format_spans([], params)


# -- the pipeline: VerbatimRAG over the hashed providers, a mocked LLM ----------------


def _first_sentence(text: str) -> str:
    end = text.find(". ")
    return text[: end + 1] if end >= 0 else text[:80]


def _llm_reply(request: httpx.Request) -> httpx.Response:
    prompt = json.loads(request.content)["messages"][-1]["content"]
    if "Documents:\n" in prompt and prompt.rstrip().endswith("JSON:"):
        docs = json.loads(prompt.split("Documents:\n", 1)[1].rsplit("\n\nJSON:", 1)[0])
        content = json.dumps({k: [_first_sentence(v)] for k, v in docs.items()})
    else:
        content = "{}"
    return httpx.Response(200, json={"choices": [{"message": {"role": "assistant", "content": content}}]})


def _client(module):
    client = module.LLMClient(model="test-model", api_key="test-key")
    client._client = httpx.Client(transport=httpx.MockTransport(_llm_reply))
    return client


@pytest.fixture(scope="module")
def rags():
    """{side: VerbatimRAG} over the example documents, hashed providers,
    exact selection, the mocked LLM's extractor and static templates."""
    port_index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(), device="cpu"
    )
    jax_index = JaxIndex(dense_provider=JaxDense(), sparse_provider=JaxSparse(), approx_topk=False)
    for index, schema in ((port_index, DocumentSchema), (jax_index, JaxSchema)):
        counter = itertools.count()  # the same document and chunk ids on both sides
        with mock.patch.object(uuid, "uuid4", lambda: uuid.UUID(int=next(counter))):
            index.add_documents([schema.from_file(str(p)) for p in DOCS])
    return {
        "port": VerbatimRAG(port_index, llm_client=_client(llm_client), template_mode="static", k=3),
        "jax": JaxRAG(jax_index, llm_client=_client(jax_llm), template_mode="static", k=3),
    }


def test_verbatim_doc_over_an_index_matches_jax(rags):
    """`process` over each package's RAG: two `query_batch` calls (k = 5 and
    2), every directive's spans those of `query("<section>: <question>",
    k)`, and the document, spans and citations equal to JAX's."""
    got = {}
    for side, rag in rags.items():
        mod = SIDES[side][0]
        calls = []
        batch = rag.query_batch
        rag.query_batch = lambda qs, k=5, **kw: calls.append((list(qs), k)) or batch(qs, k=k, **kw)
        try:
            resp = mod.VerbatimDOC(rag).process(REPORT)
        finally:
            del rag.query_batch
        got[side] = (_dump(resp), calls)
        for r in resp.queries:
            question = f"{r.query.section}: {r.query.text}" if r.query.section else r.query.text
            single = rag.query(question, k=r.query.params.get("k", 5))
            assert r.spans == [
                {"text": h.text, "doc_title": d.title or d.source or f"document {i}", "doc_index": i}
                for i, d in enumerate(single.documents)
                for h in d.highlights
            ]
    assert got["port"] == got["jax"]
    assert [k for _, k in got["port"][1]] == [5, 2]
    assert got["port"][0]["citations"] and "[!query" not in got["port"][0]["document"]


def test_stream_process_over_an_index_matches_jax(rags):
    async def collect(mod, rag):
        return [e async for e in mod.VerbatimDOC(rag).stream_process(REPORT)]

    got = {side: asyncio.run(collect(SIDES[side][0], rag)) for side, rag in rags.items()}
    assert got["port"] == got["jax"]
    done = got["port"][-1]
    assert done["type"] == "done"
    assert done["document"] == verbatim_doc.VerbatimDOC(rags["port"]).process(REPORT).document


@pytest.mark.parametrize("search_type", [None, "dense", "sparse"])
def test_index_provider_matches_jax(rags, search_type):
    question = "How efficient are solar panels?"
    ours = providers.IndexProvider(rags["port"].index, search_type=search_type).retrieve(question, k=4)
    theirs = jax_providers.IndexProvider(rags["jax"].index, search_type=search_type).retrieve(question, k=4)
    assert ours == theirs and ours


def test_verbatim_rag_provider_matches_jax(rags):
    question = "Why do offshore wind farms produce more energy?"
    ours = providers.VerbatimRAGProvider(rags["port"]).retrieve(question, k=3)
    theirs = jax_providers.VerbatimRAGProvider(rags["jax"]).retrieve(question, k=3)
    assert ours == theirs and ours


# -- verbatim_enhance -----------------------------------------------------------------


def _transforms():
    return {
        "port": VerbatimTransform(
            llm_client=_client(llm_client), template_manager=TemplateManager(default_mode="static")
        ),
        "jax": JaxTransform(
            llm_client=_client(jax_llm), template_manager=JaxTemplateManager(default_mode="static")
        ),
    }


CHUNKS = ["Chunk about X marks the spot. More here.", "Chunk about Y is here. And more."]
SHAPES = {
    "bare_two_item_list": lambda question: list(CHUNKS),
    "answer_sources_tuple": lambda question: ("an answer", [{"content": CHUNKS[0], "title": "t"}]),
    "dict_context": lambda question: {"answer": "a", "context": [{"text": CHUNKS[1], "source": "s"}]},
    "dict_sources": lambda question: {"sources": CHUNKS},
    "single_mapping": lambda question: {"content": CHUNKS[0], "metadata": {"m": 1}},
    "raw_text": lambda question: CHUNKS[0],
    "none": lambda question: None,
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_enhance_shapes_match_jax(shape):
    got = {}
    for side, vt in _transforms().items():
        enhance = verbatim_enhance if side == "port" else jax_enhance
        got[side] = enhance(transform=vt)(SHAPES[shape])("where is X?").model_dump()
    assert got["port"] == got["jax"]


def test_enhance_on_a_bound_method_matches_jax():
    got = {}
    for side, vt in _transforms().items():
        enhance = verbatim_enhance if side == "port" else jax_enhance

        class Pipeline:
            @enhance(transform=vt)
            def run(self, question):
                return {"context": [CHUNKS[0]]}

        got[side] = Pipeline().run("what is the answer?").model_dump()
    assert got["port"] == got["jax"]
    assert got["port"]["question"] == "what is the answer?"


def test_enhance_over_an_index_provider_matches_transform(rags):
    """The decorator around `IndexProvider(index).retrieve` answers as
    `transform` on the same contexts, in both packages and equal across
    them."""
    question = "How efficient are solar panels?"
    got = {}
    for side, vt in _transforms().items():
        mod, enhance = (providers, verbatim_enhance) if side == "port" else (jax_providers, jax_enhance)
        provider = mod.IndexProvider(rags[side].index)
        wrapped = enhance(transform=vt)(lambda question: provider.retrieve(question, k=3))
        got[side] = wrapped(question).model_dump()
        assert got[side] == vt.transform(question, provider.retrieve(question, k=3)).model_dump()
    assert got["port"] == got["jax"]


# -- the verbatim-enhance CLI ---------------------------------------------------------

RECORDS = [
    {"question": "what was found?", "context": [{"content": "The study found X improves Y. Later work agreed."}]},
    {"question": "and the sources?", "sources": ["Sources say Z. They are many.", "Another source. With text."]},
    {"question": "nothing", "context": []},
]


@pytest.mark.parametrize(
    "layout", ["jsonl", "json_array", "bom_and_whitespace_array", "jsonl_blank_lines"]
)
def test_iter_records_matches_jax(tmp_path, layout):
    path = tmp_path / "records"
    if layout == "jsonl":
        path.write_text("".join(json.dumps(r) + "\n" for r in RECORDS))
    elif layout == "json_array":
        path.write_text(json.dumps(RECORDS))
    elif layout == "bom_and_whitespace_array":
        path.write_bytes(("﻿\n  " + json.dumps(RECORDS, indent=1)).encode("utf-8"))
    else:
        path.write_text("\n\n".join(json.dumps(r) for r in RECORDS) + "\n\n")
    ours = list(cli._iter_records(str(path)))
    assert ours == list(jax_cli._iter_records(str(path))) == RECORDS


@pytest.mark.parametrize("layout", ["jsonl", "bom_array"])
def test_cli_output_matches_jax_byte_for_byte(tmp_path, monkeypatch, layout):
    """Both CLIs through the mocked LLM (static templates): the JSONL they
    write is byte-equal, and so are the requests they send."""
    records = tmp_path / "in"
    if layout == "jsonl":
        records.write_text("".join(json.dumps(r) + "\n" for r in RECORDS))
    else:
        records.write_bytes(("﻿ " + json.dumps(RECORDS)).encode("utf-8"))
    sent = {}
    for side, main, module in (("port", cli.main, llm_client), ("jax", jax_cli.main, jax_llm)):
        log = sent.setdefault(side, [])

        def handler(request, log=log):
            log.append((str(request.url), json.loads(request.content)))
            return _llm_reply(request)

        monkeypatch.setattr(
            module.LLMClient, "_sync_client", lambda self, h=handler: httpx.Client(transport=httpx.MockTransport(h))
        )
        argv = [str(records), "-o", str(tmp_path / f"{side}.jsonl"), "--model", "m-1",
                "--api-base", "http://llm.invalid/v1", "--max-display-spans", "1"]
        assert main(argv) == 0
    ours = (tmp_path / "port.jsonl").read_bytes()
    assert ours == (tmp_path / "jax.jsonl").read_bytes()
    assert sent["port"] == sent["jax"] and sent["port"]
    lines = ours.decode().splitlines()
    assert len(lines) == 3 and "The study found X improves Y." in json.loads(lines[0])["answer"]


def test_cli_writes_to_stdout_like_jax(tmp_path, monkeypatch, capsys):
    records = tmp_path / "in.jsonl"
    records.write_text(json.dumps(RECORDS[0]) + "\n")
    out = {}
    for side, main, module in (("port", cli.main, llm_client), ("jax", jax_cli.main, jax_llm)):
        monkeypatch.setattr(
            module.LLMClient, "_sync_client", lambda self: httpx.Client(transport=httpx.MockTransport(_llm_reply))
        )
        assert main([str(records), "--template-mode", "static", "--api-base", "http://llm.invalid/v1"]) == 0
        out[side] = capsys.readouterr().out
    assert out["port"] == out["jax"] and out["port"].count("\n") == 1
