"""Each module the PyTorch port copies from the JAX package, pinned to its
original: same outputs on the same inputs (bit-equal where the copy is
numpy or pure Python)."""

from __future__ import annotations

import dataclasses
import datetime
import enum
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest

from verbatim_rag_tpu.core.models import Highlight as JaxHighlight
from verbatim_rag_tpu.core.response_builder import ResponseBuilder as JaxResponseBuilder
from verbatim_rag_tpu.core.templates import TemplateManager as JaxTemplateManager
from verbatim_rag_tpu.engine import embedding_providers as jax_providers
from verbatim_rag_tpu.engine import filters as jax_filters
from verbatim_rag_tpu.engine import store as jax_store
from verbatim_rag_tpu.engine.search_result import SearchResult as JaxSearchResult
from verbatim_rag_tpu.ingestion import chunkers as jax_chunkers
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.models import config as jax_config
from verbatim_rag_tpu.models import tokenizer as jax_tokenizer
from verbatim_rag_tpu.ops import fused_topk as jax_ft
from verbatim_rag_tpu.ops import section as jax_section
from verbatim_rag_tpu.ops import sparse_projected as jax_sp
from verbatim_rag_tpu.training import dataset as jax_dataset
from verbatim_rag_tpu.training import token_dataset as jax_token_dataset
from verbatim_rag_tpu_torch.core.models import Highlight
from verbatim_rag_tpu_torch.core.response_builder import ResponseBuilder
from verbatim_rag_tpu_torch.core.templates import TemplateManager
from verbatim_rag_tpu.engine import native as jax_native
from verbatim_rag_tpu_torch.engine import analyzer
from verbatim_rag_tpu_torch.engine import embedding_providers as providers
from verbatim_rag_tpu_torch.engine import filters
from verbatim_rag_tpu_torch.engine import store
from verbatim_rag_tpu_torch.engine.search_result import SearchResult
from verbatim_rag_tpu_torch.ingestion import chunkers
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import config
from verbatim_rag_tpu_torch.models import tokenizer
from verbatim_rag_tpu_torch.ops import fused_topk as ft
from verbatim_rag_tpu_torch.ops import section
from verbatim_rag_tpu_torch.ops import sparse_projected as sp
from verbatim_rag_tpu_torch.training import dataset
from verbatim_rag_tpu_torch.training import token_dataset

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "example_docs"
TEXTS = [
    "Solar panels convert sunlight, efficiently (about 22%)!",
    "",
    "Ünïcode wörds and ASCII words — mixed; punctuation...",
    " ".join(["wind"] * 700),
]


@pytest.mark.parametrize("vocab,d_p,seed", [(30522, 768, 0), (1000, 32, 7)])
def test_projection_matrix_bit_equal(vocab, d_p, seed):
    np.testing.assert_array_equal(
        sp.projection_matrix(vocab, d_p, seed), jax_sp.projection_matrix(vocab, d_p, seed)
    )


def test_project_sparse_queries_bit_equal():
    proj = sp.projection_matrix(500, 16, 1)
    rows = [{3: 1.5, 499: 0.25, 7: 2.0}, {}, {1000: 3.0, 0: 1.0}]
    np.testing.assert_array_equal(
        sp.project_sparse_queries(rows, proj), jax_sp.project_sparse_queries(rows, proj)
    )


def test_project_rows_matches_jax():
    import torch

    rng = np.random.default_rng(0)
    proj = sp.projection_matrix(300, 24, 2)
    ids = rng.integers(0, 300, size=(10, 6)).astype(np.int32)
    w = rng.random((10, 6), dtype=np.float32)
    w[:, -2:] = 0.0
    got = sp.project_rows(torch.from_numpy(ids), torch.from_numpy(w), torch.from_numpy(proj))
    np.testing.assert_allclose(got.numpy(), jax_sp.project_rows(ids, w, proj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("max_length", [16, 512])
def test_hash_tokenizer_ids_and_offsets_equal(text, max_length):
    ours = tokenizer.HashTokenizer(vocab_size=5000)
    theirs = jax_tokenizer.HashTokenizer(vocab_size=5000)
    a = ours.encode_batch([text, "a pair"], max_length=max_length, with_offsets=True)
    b = theirs.encode_batch([text, "a pair"], max_length=max_length, with_offsets=True)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
    assert a.offsets == b.offsets
    assert ours.tokenize_with_offsets(text) == theirs.tokenize_with_offsets(text)
    pair_a = ours.encode_batch([text], max_length=max_length, pair=["question words"])
    pair_b = theirs.encode_batch([text], max_length=max_length, pair=["question words"])
    np.testing.assert_array_equal(pair_a.input_ids, pair_b.input_ids)


@pytest.mark.parametrize("n", [1, 64, 65, 8192, 8193, 20000])
def test_bucket_length_equal(n):
    assert tokenizer.bucket_length(n) == jax_tokenizer.bucket_length(n)
    assert tokenizer.DEFAULT_BUCKETS == jax_tokenizer.DEFAULT_BUCKETS


@pytest.mark.parametrize("text", TEXTS)
def test_hashed_providers_equal(text):
    np.testing.assert_array_equal(
        providers.HashedBowDenseProvider(dim=96).embed_text(text),
        jax_providers.HashedBowDenseProvider(dim=96).embed_text(text),
    )
    assert providers.HashedSparseProvider(2048).embed_text(text) == (
        jax_providers.HashedSparseProvider(2048).embed_text(text)
    )
    assert providers.HashedSparseProvider().describe() == jax_providers.HashedSparseProvider().describe()


@pytest.mark.parametrize("value", ["abc", 17, 3.5, None, True, ("a", 1)])
def test_stable_hash_equal(value):
    assert filters.stable_hash64(value) == jax_filters.stable_hash64(value)


@pytest.mark.parametrize(
    "flt",
    [None, {"document_id": "d1"}, {"user_id": "u2", "tag": "x"}, "tag == 'x' and year >= 2020"],
)
def test_compile_filter_equal(flt):
    meta = [
        {"document_id": f"d{i % 3}", "user_id": f"u{i % 2}", "tag": "xy"[i % 2], "year": 2015 + i}
        for i in range(8)
    ]
    promoted = {
        f: np.array([filters.stable_hash64(m.get(f)) if m.get(f) else 0 for m in meta], np.int64)
        for f in filters.PROMOTED_FIELDS
    }
    a = filters.compile_filter(flt, len(meta), promoted, meta)
    b = jax_filters.compile_filter(flt, len(meta), promoted, meta)
    assert (a is None and b is None) or np.array_equal(a, b)


def test_config_presets_equal():
    for name in (
        "tiny_test_config", "modernbert_base_config", "demo_highlighter_config",
        "minilm_config", "bert_base_config",
    ):
        ours, theirs = getattr(config, name)(), getattr(jax_config, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert config.modernbert_base_config().head_dim == 64
    assert config.minilm_config().head_dim == 32 and config.bert_base_config().head_dim == 64


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.md")), ids=lambda p: p.name)
def test_schema_and_chunkers_equal(path):
    ours, theirs = DocumentSchema.from_file(str(path)), JaxSchema.from_file(str(path))
    assert ours.model_dump() == theirs.model_dump()
    for kwargs in (dict(split_level=2, min_chunk_size=64), dict(split_level=1, max_chunk_size=80)):
        assert chunkers.MarkdownChunkerProvider(**kwargs).chunk(ours.content) == (
            jax_chunkers.MarkdownChunkerProvider(**kwargs).chunk(theirs.content)
        )
    assert chunkers.SimpleChunkerProvider(chunk_size=50, overlap=10).chunk(ours.content) == (
        jax_chunkers.SimpleChunkerProvider(chunk_size=50, overlap=10).chunk(theirs.content)
    )


def test_response_builder_and_templates_equal():
    content = "Solar panels work. Solar panels are efficient. Wind too."
    spans = {content: ["Solar panels", "Wind too."]}
    results = [SearchResult(id="a", text=content, metadata={"title": "t"})]
    jax_results = [JaxSearchResult(id="a", text=content, metadata={"title": "t"})]
    display = [{"text": "Solar panels", "doc_text": content}]
    citation = [{"text": "Wind too.", "doc_text": content}]
    answer = TemplateManager().process("q?", display, citation)
    assert answer == JaxTemplateManager().process("q?", display, citation)
    ours = ResponseBuilder().build_response("q?", answer, results, spans, display_span_count=1)
    theirs = JaxResponseBuilder().build_response("q?", answer, jax_results, spans, display_span_count=1)
    assert ours.model_dump() == theirs.model_dump()
    assert ResponseBuilder().clean_answer('"a  b\\n"') == JaxResponseBuilder().clean_answer('"a  b\\n"')
    assert Highlight(text="x", start=0, end=1).model_dump() == JaxHighlight(text="x", start=0, end=1).model_dump()


class _Color(enum.Enum):
    RED = "red"


@pytest.mark.parametrize(
    "value",
    [datetime.date(2024, 1, 2), _Color.RED, {3, 1, 2}, np.int64(5), Path("x/y")],
)
def test_store_helpers_equal(value):
    assert store.json_safe(value) == jax_store.json_safe(value)


@pytest.mark.parametrize("entries,nnz", [({5: 1.0, 2: 0.0, 9: -3.0}, 2), ([(1, 0.5)], 4), ({}, 3)])
def test_pad_sparse_equal(entries, nnz):
    for a, b in zip(store._pad_sparse(entries, nnz), jax_store._pad_sparse(entries, nnz)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "payload",
    [(np.zeros((2, 3)), np.zeros((2, 3))), [{1: 1.0}], ({1: 1.0}, {2: 1.0}), (np.zeros(3), np.zeros(3))],
)
def test_is_sparse_arrays_equal(payload):
    assert store._is_sparse_arrays(payload) == jax_store._is_sparse_arrays(payload)


@pytest.mark.parametrize("i", range(len(TEXTS) + 1))
def test_analyzer_copy_equal(i, monkeypatch):
    """The BM25 analyzer's copied parts: FNV-1a per token, the Python
    fallback (the JAX store's `_analyze` with its scanner unloaded), the
    token cap and the scanner's unique-term limit."""
    text = (TEXTS + ["Ü" * 3 + "K" + "ab" * 200])[i]
    for token in text.split() or [""]:
        assert analyzer.fnv1a(token) == jax_store._fnv1a(token)
    assert analyzer.SCANNER_MAX_TERMS == jax_native.analyze_text_native.__defaults__[0]
    assert analyzer.TOKEN_BYTES == 256
    monkeypatch.setattr(jax_native, "analyze_text_native", lambda *a, **k: None)
    for got, expected in zip(analyzer.analyze_fallback(text, 1000), jax_store._analyze(text, 1000)):
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("n", [1, 384, 960, 2048, 8192, 16384, 123 * 8192, 999_424, 2048 * 17])
def test_bucket_geometry_equal(n):
    assert ft.choose_block_rows(n) == jax_ft.choose_block_rows(n)
    assert ft.bucket_table_width(n) == jax_ft.bucket_table_width(n)
    assert (ft.BUCKET, ft.BLOCK_ROWS, ft.MIN_BLOCK_ROWS) == (
        jax_ft.BUCKET, jax_ft.BLOCK_ROWS, jax_ft.MIN_BLOCK_ROWS
    )
    assert (section.LANE, section.BLOCK_COLS) == (jax_section.LANE, jax_section.BLOCK_COLS)


def test_bucket_v1_constants_equal():
    """v1's bucket width, largest block and masked score are the JAX module's."""
    assert (ft.BUCKET, ft.BLOCK_ROWS, ft.NEG_INF) == (
        jax_ft.BUCKET, jax_ft.BLOCK_ROWS, jax_ft.NEG_INF
    )


def test_pack_and_unpack_bit_equal():
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(1)
    scores = (rng.normal(size=(6, 256)) * 10.0 ** rng.integers(-30, 30, size=(6, 256))).astype(np.float32)
    scores[0, :4] = [0.0, -0.0, -1e30, 1e30]
    pos = rng.integers(0, 128, size=(6, 256)).astype(np.int32)
    packed = ft._pack_pos(torch.from_numpy(scores), torch.from_numpy(pos))
    expected = jax_ft._pack_pos(jnp.asarray(scores), jnp.asarray(pos))
    np.testing.assert_array_equal(packed.numpy().view(np.int32), np.array(expected).view(np.int32))
    for ours, theirs in (
        (ft._unpack(packed), jax_ft._unpack(expected)),
        (section.unpack_table(packed), jax_section.unpack_table(expected)),
    ):
        np.testing.assert_array_equal(ours[0].numpy().view(np.int32), np.array(theirs[0]).view(np.int32))
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))


def test_training_config_equal():
    assert dataclasses.asdict(config.TrainingConfig()) == dataclasses.asdict(jax_config.TrainingConfig())
    kwargs = dict(learning_rate=1e-3, warmup_steps=7, max_grad_norm=0.5, extra={"a": 1})
    assert dataclasses.asdict(config.TrainingConfig(**kwargs)) == dataclasses.asdict(
        jax_config.TrainingConfig(**kwargs)
    )


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("max_length,max_sentences", [(64, 4), (512, 64)])
def test_sentence_dataset_batches_bit_equal(tmp_path, max_length, max_sentences):
    ours = dataset.make_synthetic_qadata(11, sentences_per_doc=7, seed=3, task="keyword")
    theirs = jax_dataset.make_synthetic_qadata(11, sentences_per_doc=7, seed=3, task="keyword")
    ours.to_json(str(tmp_path / "a.json"))
    theirs.to_json(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    loaded = dataset.QAData.from_json(str(tmp_path / "b.json"))
    assert loaded.filter_split("dev") and loaded.filter_split("train")
    args = (max_length, max_sentences)
    _assert_batches_equal(
        dataset.QADatasetEncoder(tokenizer.HashTokenizer(5000), *args).iter_batches(
            loaded.samples, 4, shuffle=True, seed=2
        ),
        jax_dataset.QADatasetEncoder(jax_tokenizer.HashTokenizer(5000), *args).iter_batches(
            theirs.samples, 4, shuffle=True, seed=2
        ),
    )


@pytest.mark.parametrize("max_length,stride", [(32, 8), (512, 128)])
def test_token_dataset_batches_bit_equal(tmp_path, max_length, stride):
    ours = token_dataset.make_synthetic_token_data(9, seed=4)
    theirs = jax_token_dataset.make_synthetic_token_data(9, seed=4)
    assert [dataclasses.asdict(e) for e in ours] == [dataclasses.asdict(e) for e in theirs]
    records = [
        {"question": e.question, "context": e.context, "answers": [list(s) for s in e.spans] + ["Clause"]}
        for e in ours
    ]
    (tmp_path / "a.jsonl").write_text("\n".join(json.dumps(r) for r in records))
    loaded = token_dataset.load_token_examples(str(tmp_path / "a.jsonl"))
    expected = jax_token_dataset.load_token_examples(str(tmp_path / "a.jsonl"))
    assert [dataclasses.asdict(e) for e in loaded] == [dataclasses.asdict(e) for e in expected]
    _assert_batches_equal(
        token_dataset.TokenDatasetEncoder(tokenizer.HashTokenizer(5000), max_length, stride).iter_batches(
            loaded, 3, shuffle=True, seed=1
        ),
        jax_token_dataset.TokenDatasetEncoder(jax_tokenizer.HashTokenizer(5000), max_length, stride).iter_batches(
            expected, 3, shuffle=True, seed=1
        ),
    )


# -- the serving layer's copies (core, rag, api) ----------------------------------------

from verbatim_rag_tpu.api import batching as jax_batching  # noqa: E402
from verbatim_rag_tpu.api import config as jax_api_config  # noqa: E402
from verbatim_rag_tpu.api import service as jax_service  # noqa: E402
from verbatim_rag_tpu.core import llm_client as jax_llm_client  # noqa: E402
from verbatim_rag_tpu.core import prompts as jax_prompts  # noqa: E402
from verbatim_rag_tpu.core import span_verify as jax_span_verify  # noqa: E402
from verbatim_rag_tpu.core import types as jax_types  # noqa: E402
from verbatim_rag_tpu.core import universal_document as jax_udoc  # noqa: E402
from verbatim_rag_tpu.rag import intent as jax_intent  # noqa: E402
from verbatim_rag_tpu_torch.api import batching  # noqa: E402
from verbatim_rag_tpu_torch.api import config as api_config  # noqa: E402
from verbatim_rag_tpu_torch.api import service  # noqa: E402
from verbatim_rag_tpu_torch.core import llm_client  # noqa: E402
from verbatim_rag_tpu_torch.core import prompts  # noqa: E402
from verbatim_rag_tpu_torch.core import span_verify  # noqa: E402
from verbatim_rag_tpu_torch.core import types as core_types  # noqa: E402
from verbatim_rag_tpu_torch.core import universal_document as udoc  # noqa: E402
from verbatim_rag_tpu_torch.rag import intent  # noqa: E402

PROMPT_FILES = sorted(p.relative_to(jax_prompts.PROMPTS_DIR) for p in jax_prompts.PROMPTS_DIR.rglob("*.txt"))


@pytest.mark.parametrize("name", PROMPT_FILES, ids=str)
def test_prompt_files_equal(name):
    assert (prompts.PROMPTS_DIR / name).read_bytes() == (jax_prompts.PROMPTS_DIR / name).read_bytes()


def test_prompt_bank_renders_equal():
    assert prompts.list_prompts() == jax_prompts.list_prompts() and len(prompts.list_prompts()) == 5
    variables = dict(question="q?", n_spans=2, spans_block="1. a", span_preview="a | b", citation_count=1,
                     has_citations=True, documents="{}", template="[X]", placeholder_spec="- X: x", docs_text="d")
    for name in prompts.list_prompts():
        assert prompts.load_prompt(name) == jax_prompts.load_prompt(name)
        assert prompts.load_prompt(name, **variables) == jax_prompts.load_prompt(name, **variables)
    inline = "{% if n > 1 %}many {{ n }}{% else %}one{% endif %}"
    assert [prompts.render_prompt(inline, n=n) for n in (1, 3)] == [jax_prompts.render_prompt(inline, n=n) for n in (1, 3)]
    with pytest.raises(FileNotFoundError):
        prompts.load_prompt("extraction/missing")


SPAN_CASES = [
    (["Solar panels convert sunlight", "  Solar  ", "", "absent words"], "Solar panels convert sunlight.", "exact", 0.8),
    (["SOLAR PANELS convert sunlight!"], "Solar panels, convert   sunlight.", "fuzzy", 0.8),
    (["Ünïcode WÖRDS mixed"], "Some ünïcode wörds — mixed; here", "fuzzy", 0.7),
    (["completely different text"], "Solar panels convert sunlight.", "fuzzy", 0.9),
    (["panels convert"], "", "fuzzy", 0.5),
]


@pytest.mark.parametrize("spans,doc,mode,threshold", SPAN_CASES)
def test_span_verification_equal(spans, doc, mode, threshold):
    assert span_verify.verify_spans(spans, doc, mode=mode, fuzzy_threshold=threshold) == (
        jax_span_verify.verify_spans(spans, doc, mode=mode, fuzzy_threshold=threshold)
    )
    for span in spans:
        assert span_verify.find_fuzzy_match(span, doc) == jax_span_verify.find_fuzzy_match(span, doc)
        assert dataclasses.astuple(span_verify.normalize_tokens(span)) == dataclasses.astuple(
            jax_span_verify.normalize_tokens(span)
        )


def test_documents_types_and_providers_equal():
    data = {"text": "body", "title": "t", "metadata": {"a": 1}}
    assert udoc.UniversalDocument.from_dict(data).to_context() == jax_udoc.UniversalDocument.from_dict(data).to_context()
    assert udoc.UniversalDocument.from_text("x", source="s").to_context() == (
        jax_udoc.UniversalDocument.from_text("x", source="s").to_context()
    )
    for bad in ({"content": ""}, ["not a dict"]):
        with pytest.raises((TypeError, ValueError)) as ours:
            udoc.UniversalDocument.from_dict(bad)
        with pytest.raises((TypeError, ValueError)) as theirs:
            jax_udoc.UniversalDocument.from_dict(bad)
        assert str(ours.value) == str(theirs.value)
    for obj in (SearchResult(id="a", text="t"), "text", object()):
        assert isinstance(obj, core_types.HasText) == isinstance(obj, jax_types.HasText)


def test_intent_records_and_prompt_equal():
    assert dataclasses.asdict(intent.IntentDecision()) == dataclasses.asdict(jax_intent.IntentDecision())
    specs = [("greet", ["hi", "hello"], "predefined", "Hi!", "greetings"), ("other", [], "skip", None, "")]
    ours = intent.LLMIntentDetector(None, [intent.IntentSpec(*s) for s in specs])
    theirs = jax_intent.LLMIntentDetector(None, [jax_intent.IntentSpec(*s) for s in specs])
    assert ours._prompt("q?") == theirs._prompt("q?")
    assert intent.LLMIntentDetector(None)._prompt("q") == jax_intent.LLMIntentDetector(None)._prompt("q")
    assert intent.ROUTES == jax_intent.ROUTES


@pytest.mark.parametrize(
    "env",
    [{}, {"API_PORT": "9001", "CORS_ORIGINS": " https://a.x , https://b.x ,", "MICRO_BATCH": "off",
          "MICRO_BATCH_MAX": "16", "MICRO_BATCH_WAIT_MS": "2.5", "LLM_MODEL": "m", "API_DEBUG": "true"}],
)
def test_api_config_from_env_equal(monkeypatch, env):
    for key in list(os.environ):
        if key.startswith(("API_", "CORS_", "MICRO_BATCH", "LLM_", "INDEX_PATH", "TEMPLATES_PATH", "MAX_QUESTION", "LOG_LEVEL")):
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert api_config.APIConfig.from_env().model_dump() == jax_api_config.APIConfig.from_env().model_dump()


def test_api_service_and_batch_key_equal():
    class Index:
        def inspect(self):
            return {"num_chunks": 3}

    rag = type("Rag", (), {"index": Index()})()
    ours, theirs = service.APIService(rag, 10), jax_service.APIService(rag, 10)
    for question in ("  ok  ", "", 5, "x" * 11):
        results = []
        for svc, error in ((ours, service.ValidationError), (theirs, jax_service.ValidationError)):
            try:
                results.append(svc.validate_question(question))
            except error as exc:
                results.append(str(exc))
        assert results[0] == results[1]
    assert ours.health_check() == theirs.health_check()
    params = {"k": 3, "filter": {"b": 1, "a": [1, 2]}, "rrf_k": 60, "when": datetime.date(2024, 1, 2)}
    assert batching._params_key(params) == jax_batching._params_key(params)


def test_llm_retry_rules_equal():
    import httpx

    request = httpx.Request("POST", "http://x/chat/completions")
    errors = [httpx.ConnectError("x", request=request), ValueError("x")]
    for status in (400, 404, 408, 429, 500, 503):
        for headers in ({}, {"Retry-After": "3"}, {"Retry-After": "120"}, {"Retry-After": "Wed, 21 Oct 2015"}):
            response = httpx.Response(status, headers=headers, request=request)
            errors.append(httpx.HTTPStatusError("x", request=request, response=response))
    for exc in errors:
        assert llm_client._retryable(exc) == jax_llm_client._retryable(exc)
        for attempt in range(7):
            assert llm_client._retry_delay_s(attempt, exc) == jax_llm_client._retry_delay_s(attempt, exc)
    holders = {"A": "a", "B": "b"}
    for raw in ({"A": ["s", {"text": "t", "doc": 2}, {"doc": 1}, 3], "B": "x"}, [1], {}):
        assert llm_client.LLMClient._normalize_structured_response(raw, holders) == (
            jax_llm_client.LLMClient._normalize_structured_response(raw, holders)
        )


# -- checkpoints, extractors, rerankers, evaluation ----------------------------------------

from verbatim_rag_tpu.models import hf_convert as jax_hf  # noqa: E402
from verbatim_rag_tpu.models import sentence_extractor as jax_sentence  # noqa: E402
from verbatim_rag_tpu.rag import rerankers as jax_rerankers  # noqa: E402
from verbatim_rag_tpu.training import eval_f1 as jax_eval_f1  # noqa: E402
from verbatim_rag_tpu.training import preprocess_ragbench as jax_ragbench  # noqa: E402
from verbatim_rag_tpu_torch.models import hf_convert  # noqa: E402
from verbatim_rag_tpu_torch.models import sentence_extractor  # noqa: E402
from verbatim_rag_tpu_torch.rag import rerankers  # noqa: E402
from verbatim_rag_tpu_torch.training import eval_f1  # noqa: E402
from verbatim_rag_tpu_torch.training import preprocess_ragbench as ragbench  # noqa: E402

SENTENCE_TEXTS = TEXTS + [
    "One. Two!  Three?\nFour\n\n  five ... six",
    "---\n...\n!!",
    "no terminal punctuation here",
]


@pytest.mark.parametrize("text", SENTENCE_TEXTS)
def test_split_sentences_equal(text):
    assert sentence_extractor.split_sentences(text) == jax_sentence.split_sentences(text)


def _numpy_state_dict(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(3):
        sd[f"l.{i}.weight"] = rng.standard_normal((5, 4)).astype(np.float32)
        if i != 1:
            sd[f"l.{i}.bias"] = rng.standard_normal(5).astype(np.float64)
    return sd


@pytest.mark.parametrize("seed", [0, 1])
def test_converter_helpers_equal(seed):
    import torch

    sd = _numpy_state_dict(seed)
    sd["t.weight"] = torch.randn(3, 2, dtype=torch.float64)
    for fn in ("_linear", "_norm"):
        for prefix in ("l.0", "l.1", "t"):
            for use_bias in (True, False):
                args = (sd, prefix, use_bias) if fn == "_linear" else (sd, prefix)
                got, expected = getattr(hf_convert, fn)(*args), getattr(jax_hf, fn)(*args)
                assert got.keys() == expected.keys()
                for key in got:
                    np.testing.assert_array_equal(got[key], expected[key])
                    assert got[key].dtype == expected[key].dtype == np.float32
    layers = [{"a": {"k": np.full((2, 3), i, np.float32)}, "b": np.arange(i, i + 4, dtype=np.float32)}
              for i in range(3)]
    got, expected = hf_convert._stack_layers(layers), jax_hf._stack_layers(layers)
    np.testing.assert_array_equal(got["a"]["k"], np.asarray(expected["a"]["k"]))
    np.testing.assert_array_equal(got["b"], np.asarray(expected["b"]))


HF_CONFIGS = [
    {"model_type": "modernbert", "vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 2,
     "num_attention_heads": 2, "intermediate_size": 48},
    {"model_type": "modernbert", "vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 4,
     "num_attention_heads": 4, "intermediate_size": 48, "max_position_embeddings": 512, "norm_eps": 1e-6,
     "global_rope_theta": 1e5, "local_rope_theta": 1e3, "local_attention": 64, "global_attn_every_n_layers": 2},
    {"vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
     "intermediate_size": 48},
    {"model_type": "bert", "vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 2,
     "num_attention_heads": 2, "intermediate_size": 48, "type_vocab_size": 1, "layer_norm_eps": 1e-7,
     "max_position_embeddings": 64},
]


@pytest.mark.parametrize("hf", HF_CONFIGS)
def test_config_from_hf_equal(hf):
    got = hf_convert.config_from_hf(hf)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_hf.config_from_hf(hf))
    assert hf_convert.hf_config_from_encoder(got) == jax_hf.hf_config_from_encoder(jax_hf.config_from_hf(hf))


def test_reranker_adapter_defaults_equal():
    hits = [SearchResult(id="a", text="plain"), type("R", (), {"text": "t", "enhanced_text": "e"})(),
            type("R", (), {"text": "t", "enhanced_text": ""})(), object()]
    for field in ("text", "enhanced_text", "missing"):
        assert rerankers._texts_for(hits, field) == jax_rerankers._texts_for(hits, field)
    for name in ("CohereReranker", "JinaReranker"):
        ours, theirs = getattr(rerankers, name)("k"), getattr(jax_rerankers, name)("k")
        assert vars(ours) == vars(theirs)
    assert set(rerankers.__all__ if hasattr(rerankers, "__all__") else dir(rerankers)) >= {
        "Reranker", "BaseReranker", "JaxReranker", "JinaV3Reranker", "CohereReranker", "JinaReranker"
    }


F1_CASES = [
    (["Solar panels convert sunlight"], ["solar panels", "sunlight!"]),
    ([], ["gold only"]),
    (["predicted only", "twice twice"], []),
    (["Ünïcode wörds, 22% efficient"], ["ünïcode WÖRDS 22"]),
    ([], []),
]


def test_eval_f1_equal():
    ours, theirs = eval_f1.F1Counts(), jax_eval_f1.F1Counts()
    for predicted, gold in F1_CASES:
        for text in predicted + gold:
            assert eval_f1.words(text) == jax_eval_f1.words(text)
        ours.add(predicted, gold)
        theirs.add(predicted, gold)
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
        assert (ours.precision, ours.recall, ours.f1) == (theirs.precision, theirs.recall, theirs.f1)
    examples = [{"question": "q", "context": " ".join(p + g), "answers": g} for p, g in F1_CASES]
    examples.append({"question": "q", "context": "no answers key"})

    def extract(question, context):
        return context.split()[:3]

    assert eval_f1.evaluate_extractor(extract, examples) == jax_eval_f1.evaluate_extractor(extract, examples)
    assert eval_f1.evaluate_extractor(extract, []) == jax_eval_f1.evaluate_extractor(extract, [])


@pytest.mark.parametrize("jsonl", [False, True])
def test_eval_examples_load_equal(tmp_path, jsonl):
    rows = [{"question": "q", "context": "c", "answers": ["c"]}, {"question": "r", "context": "d"}]
    path = tmp_path / "rows.json"
    path.write_text("\n\n".join(json.dumps(r) for r in rows) + "\n" if jsonl else json.dumps(rows))
    assert eval_f1.load_examples(str(path)) == jax_eval_f1.load_examples(str(path)) == rows


RAGBENCH_ROWS = [
    {"question": "q1", "all_relevant_sentence_keys": ["0a", "1b"],
     "documents_sentences": [[["0a", "First."], ["0b", "Second."]], [["1a", "  "], ["1b", "Third!"]]]},
    {"question": "q2", "all_relevant_sentence_keys": None,
     "documents_sentences": [[["0a", "Only."], ["bad"], "not a pair", ["0c", ""]]]},
    {"question": "q3", "documents_sentences": [[], [["x", None]]]},
    {"documents_sentences": None},
    {"question": "q5", "all_relevant_sentence_keys": ["k"], "documents_sentences": [[("k", "Tuple item.")]]},
]


@pytest.mark.parametrize("row", RAGBENCH_ROWS)
def test_ragbench_convert_example_equal(row):
    got, expected = ragbench.convert_example(row), jax_ragbench.convert_example(row)
    assert (got is None) == (expected is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(expected)
    assert ragbench.RAGBENCH_SUBSETS == jax_ragbench.RAGBENCH_SUBSETS


@pytest.mark.parametrize("global_batch,n_proc,rank", [(12, 4, 1), (8, 2, 1), (8, 1, 0), (10, 4, 3), (7, 2, 0)])
def test_process_local_batch_slice_equal(monkeypatch, global_batch, n_proc, rank):
    """`parallel/distributed.py::process_local_batch_slice` over the port's
    process count and rank, against JAX's over ``jax.process_count`` and
    ``jax.process_index``: the same slice, or the same ``ValueError``."""
    import jax

    from verbatim_rag_tpu.parallel import distributed as jax_distributed
    from verbatim_rag_tpu_torch.parallel import distributed

    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(distributed, "process_count", lambda: n_proc)
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    outcomes = []
    for fn in (distributed.process_local_batch_slice, jax_distributed.process_local_batch_slice):
        try:
            outcomes.append(fn(global_batch))
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


# -- the copied orchestration modules: the same source ----------------------------------

_SAME_SOURCE = {
    "ingestion.html_convert": ("_Markdownifier", "html_to_markdown"),
    "ingestion.document_processor": (
        "_docling_convert", "_csv_to_markdown", "_json_to_markdown", "DocumentProcessor",
    ),
    "ingestion.extra_chunkers": (
        "ChonkieChunkerProvider", "HeadingPathWrapper", "ChunkingStrategy", "chunk_with_strategy",
    ),
    "engine.embedding_providers": ("OpenAIEmbeddingProvider",),
    "rag.verbatim_doc": (
        "_parse_params", "DocQuery", "QueryResult", "Parser", "Processor", "_format_spans",
        "Replacer", "VerbatimDocResponse", "VerbatimDOC",
    ),
    "rag.providers": ("IndexProvider", "VerbatimRAGProvider"),
    "core.enhance": ("_to_context_dicts", "verbatim_enhance"),
    "core.cli": ("_iter_records", "main"),
}


@pytest.mark.parametrize("module", sorted(_SAME_SOURCE))
def test_copied_orchestration_source_equals_the_original(module):
    """Each JAX-free module this package copies keeps the original's code
    for every class and function (the CLI's program name drops "-tpu");
    the behaviour is held to JAX's in `test_torch_doc.py`,
    `test_torch_ingestion_extras.py` and `test_torch_remote_embeddings.py`."""
    import importlib
    import inspect

    ours = importlib.import_module(f"verbatim_rag_tpu_torch.{module}")
    theirs = importlib.import_module(f"verbatim_rag_tpu.{module}")
    for name in _SAME_SOURCE[module]:
        got = inspect.getsource(getattr(ours, name))
        want = inspect.getsource(getattr(theirs, name)).replace("verbatim-enhance-tpu", "verbatim-enhance")
        assert got == want, f"{module}.{name} differs from the original"


@pytest.mark.parametrize(
    "shim",
    ["extractors", "llm_client", "models", "response_builder", "templates", "transform", "universal_document"],
)
def test_rag_shims_reexport_the_ports_own_objects(shim):
    """Each compat shim of `rag/` exports JAX's names, each bound to the
    port's own object (JAX's shims bind JAX's)."""
    import importlib

    ours = importlib.import_module(f"verbatim_rag_tpu_torch.rag.{shim}")
    theirs = importlib.import_module(f"verbatim_rag_tpu.rag.{shim}")
    assert ours.__all__ == theirs.__all__
    for name in ours.__all__:
        obj = getattr(ours, name)
        assert obj.__module__.startswith("verbatim_rag_tpu_torch."), (shim, name)
        assert obj.__name__ == getattr(theirs, name).__name__


# -- the C++ host runtime: the JAX package's source, byte for byte ---------------------

REPO = Path(__file__).resolve().parent.parent
HOST_FUNCTIONS = (
    "native_threads", "parallel_rows", "project_rows", "exact_rescore", "fnv1a", "analyze_text",
    "word_hash", "hash_tokenize",
)


def _cpp_function(source: str, name: str) -> str:
    """The definition of ``name``: from its signature's line to the first
    closing brace at the start of a line."""
    match = re.search(rf"^[^\n;/]*\b{name}\(.*?^}}", source, re.M | re.S)
    assert match, name
    return match.group(0)


@pytest.mark.parametrize("name", HOST_FUNCTIONS)
def test_host_runtime_functions_equal_the_original(name):
    """`csrc/host/verbatim_host.cpp` is `native/verbatim_host.cpp` byte for
    byte, and its batch file includes it and redefines none of its
    functions."""
    original = (REPO / "native" / "verbatim_host.cpp").read_text()
    copy = (REPO / "verbatim_rag_tpu_torch" / "csrc" / "host" / "verbatim_host.cpp").read_text()
    assert copy == original
    assert _cpp_function(copy, name) == _cpp_function(original, name)
    batch = (REPO / "verbatim_rag_tpu_torch" / "csrc" / "host" / "verbatim_host_batch.cpp").read_text()
    assert '#include "verbatim_host.cpp"' in batch
    assert not re.search(rf"^\S[^\n;]*\b{name}\(", batch, re.M)
