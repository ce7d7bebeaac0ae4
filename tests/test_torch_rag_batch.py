"""VerbatimRAG's batched, async and warm-up entries on the PyTorch port,
with the neural providers, vs the JAX package.

Both sides ingest `examples/example_docs` with tiny neural providers (the
dense provider and SPLADE in a narrow MiniLM shape: two heads of 32, float32)
and answer through a tiny ModernBERT-style extractor, one set of weights per
model carried from JAX with `params_from_jax`. Retrieval selects exactly
on both sides (``approx_topk=False`` in the JAX store). The port's
`query_batch` must give JAX's `query_batch` answers, retrieved chunks and
highlights exactly; within the port `query_batch` equals per-question
`query`, `query_async` equals `query`, `add_documents_batch` equals
`add_documents_bulk`, and the device handoff of query encodings equals
``VERBATIM_DEVICE_HANDOFF=0``.
"""

from __future__ import annotations

import asyncio
import logging
from pathlib import Path

import numpy as np
import pytest

import jax

from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.models.config import minilm_config as jax_minilm_config
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.encoder import init_encoder_params
from verbatim_rag_tpu.models.highlighter import ModelSpanExtractor as JaxExtractor
from verbatim_rag_tpu.models.highlighter import init_highlighter_params
from verbatim_rag_tpu.models.providers import JaxDenseProvider as JaxDense
from verbatim_rag_tpu.models.providers import JaxSpladeProvider as JaxSplade
from verbatim_rag_tpu.models.splade import init_splade_params
from verbatim_rag_tpu.rag import VerbatimRAG as JaxRAG
from verbatim_rag_tpu_torch.engine import VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import JaxDenseProvider, JaxSpladeProvider, ModelSpanExtractor
from verbatim_rag_tpu_torch.models.config import minilm_config, tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax
from verbatim_rag_tpu_torch.rag import VerbatimRAG

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))
QUESTIONS = [
    "How efficient are solar panels?",
    "Where do offshore wind farms get steadier wind?",
    "How is energy stored for the night?",
    "What limits photovoltaic output on cloudy days?",
    "wind",
]
PROVIDER = dict(
    hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128, vocab_size=1024,
    max_position_embeddings=128, compute_dtype="float32",
)
EXTRACTOR = dict(
    vocab_size=1024, hidden_size=32, num_heads=2, num_layers=3, intermediate_size=32,
    max_position_embeddings=8192, position_embedding_type="rope", norm_location="pre",
    activation="geglu", use_bias=False, final_norm=True, type_vocab_size=0,
    first_layer_no_attn_norm=True, layer_norm_eps=1e-5, local_attention_window=16,
    use_flash_attention=True,
)
K = 3


def _state(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def weights():
    jax_cfg = jax_minilm_config(**PROVIDER)
    return dict(
        dense=init_encoder_params(jax.random.PRNGKey(11), jax_cfg),
        splade=init_splade_params(jax.random.PRNGKey(12), jax_cfg),
        extractor=init_highlighter_params(jax.random.PRNGKey(13), jax_tiny_config(**EXTRACTOR)),
    )


def _port_rag(weights, docs=None, bulk=False):
    cfg = minilm_config(**PROVIDER)
    index = VerbatimIndex(
        dense_provider=JaxDenseProvider(
            params=_state(weights["dense"]), config=cfg, max_length=128, batch_size=4, device="cpu"
        ),
        sparse_provider=JaxSpladeProvider(
            params=_state(weights["splade"]), config=cfg, max_length=128, batch_size=4,
            max_nnz=32, device="cpu",
        ),
        device="cpu",
    )
    extractor = ModelSpanExtractor(
        params=_state(weights["extractor"]), config=tiny_test_config(**EXTRACTOR), device="cpu"
    )
    rag = VerbatimRAG(index, extractor=extractor, k=K)
    if docs is None:
        docs = [DocumentSchema.from_file(str(p)) for p in DOCS]
    if docs:
        if bulk:
            index.add_documents_bulk(docs, chunk_batch_size=3)
        else:
            rag.add_documents_batch(docs, chunk_batch_size=3)
    return rag


@pytest.fixture(scope="module")
def port_rag(weights):
    return _port_rag(weights)


@pytest.fixture(scope="module")
def jax_responses(weights):
    jax_cfg = jax_minilm_config(**PROVIDER)
    index = JaxIndex(
        dense_provider=JaxDense(params=weights["dense"], config=jax_cfg, max_length=128, batch_size=4),
        sparse_provider=JaxSplade(
            params=weights["splade"], config=jax_cfg, max_length=128, batch_size=4, max_nnz=32
        ),
        approx_topk=False,
    )
    rag = JaxRAG(
        index,
        extractor=JaxExtractor(params=weights["extractor"], config=jax_tiny_config(**EXTRACTOR)),
        k=K,
    )
    rag.add_documents_batch([JaxSchema.from_file(str(p)) for p in DOCS], chunk_batch_size=3)
    return rag.query_batch(QUESTIONS)


def _view(response):
    """Answer, then per retrieved chunk: its text, title, position in its
    document and highlights; the citations."""
    return (
        response.answer,
        [
            (d.content, d.title, d.metadata.get("chunk_index"),
             [(h.start, h.end, h.text) for h in d.highlights])
            for d in response.documents
        ],
        [(c.text, c.doc_index, c.number, c.type) for c in response.structured_answer.citations],
    )


def _ids(response):
    return [(d.metadata["document_id"], d.metadata["chunk_index"]) for d in response.documents]


@pytest.fixture(scope="module")
def batch(port_rag):
    return port_rag.query_batch(QUESTIONS)


@pytest.mark.parametrize("i", range(len(QUESTIONS)))
def test_query_batch_matches_jax(batch, jax_responses, i):
    assert len(batch) == len(jax_responses) == len(QUESTIONS)
    assert len(batch[i].documents) == K
    assert _view(batch[i]) == _view(jax_responses[i])


def test_query_batch_has_highlights_that_are_verbatim(batch):
    assert any(d.highlights for r in batch for d in r.documents)
    for response in batch:
        for doc in response.documents:
            for h in doc.highlights:
                assert doc.content[h.start : h.end] == h.text


@pytest.mark.parametrize("i", range(len(QUESTIONS)))
def test_query_batch_equals_query(port_rag, batch, i):
    single = port_rag.query(QUESTIONS[i])
    assert _ids(batch[i]) == _ids(single)
    assert _view(batch[i]) == _view(single)


@pytest.mark.parametrize("i", [0, 2])
def test_query_async_equals_query(port_rag, i):
    got = asyncio.run(port_rag.query_async(QUESTIONS[i]))
    expected = port_rag.query(QUESTIONS[i])
    assert _ids(got) == _ids(expected) and _view(got) == _view(expected)


def test_concurrent_query_async_equals_query(port_rag):
    async def gather():
        return await asyncio.gather(*(port_rag.query_async(q) for q in QUESTIONS))

    for got, q in zip(asyncio.run(gather()), QUESTIONS):
        expected = port_rag.query(q)
        assert _ids(got) == _ids(expected) and _view(got) == _view(expected)


def test_warmup_on_empty_and_filled_index(weights, port_rag, caplog):
    empty = _port_rag(weights, docs=[])
    with caplog.at_level(logging.INFO, logger="verbatim_rag_tpu_torch.rag.core"):
        empty.warmup()
        port_rag.warmup()
    messages = [r.getMessage() for r in caplog.records]
    assert "warmup skipped: empty index" in messages
    assert not any("warmup query failed" in m for m in messages)


def test_warmup_logs_a_failing_query(weights, port_rag, caplog, monkeypatch):
    """A failing warm-up query is logged, not raised (the JAX behaviour)."""

    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(port_rag.index, "query", broken)
    with caplog.at_level(logging.WARNING, logger="verbatim_rag_tpu_torch.rag.core"):
        port_rag.warmup()
    assert any("warmup query failed: boom" in r.getMessage() for r in caplog.records)


def test_add_documents_batch_equals_add_documents_bulk(weights, batch):
    bulk = _port_rag(weights, bulk=True)
    assert bulk.index.inspect() == _port_rag(weights).index.inspect()
    for got, expected in zip(bulk.query_batch(QUESTIONS), batch):
        assert _view(got) == _view(expected)


def test_device_handoff_equals_host_materialization(port_rag, batch, monkeypatch):
    """With the handoff the store receives the query encodings as tensors
    and arrays; with ``VERBATIM_DEVICE_HANDOFF=0`` as host arrays and term
    dicts. Both give the same responses."""
    store = port_rag.index.store
    seen = []
    original = store.query_batch

    def spy(*args, **kwargs):
        seen.append((type(kwargs["dense_queries"]).__name__, type(kwargs["sparse_queries"]).__name__))
        return original(*args, **kwargs)

    monkeypatch.setattr(store, "query_batch", spy)
    on = port_rag.query_batch(QUESTIONS)
    monkeypatch.setenv("VERBATIM_DEVICE_HANDOFF", "0")
    off = port_rag.query_batch(QUESTIONS)
    assert seen == [("Tensor", "tuple"), ("ndarray", "list")]
    for a, b, c in zip(on, off, batch):
        assert _ids(a) == _ids(b) == _ids(c)
        assert _view(a) == _view(b) == _view(c)


def test_ingest_takes_the_sparse_array_fast_path(weights, monkeypatch):
    """The store receives SPLADE rows as (ids, weights) arrays, not dicts."""
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    records = []
    original = DeviceVectorStore.add_vectors

    def spy(self, recs):
        records.extend(recs)
        return original(self, recs)

    monkeypatch.setattr(DeviceVectorStore, "add_vectors", spy)
    _port_rag(weights)
    assert records and all("sparse_arrays" in r and "sparse" not in r for r in records)
    ids, w = records[0]["sparse_arrays"]
    assert ids.dtype == np.int32 and w.dtype == np.float32 and ids.shape == (32,)
