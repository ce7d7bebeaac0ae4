"""The offline quickstart flow on the PyTorch port vs the JAX package.

Both sides ingest `examples/example_docs` with the hashed providers and
answer the same questions through `VerbatimRAG.query`, the extractor being
the tiny ModernBERT-style highlighter with one set of weights (JAX init,
converted with `params_from_jax`). Retrieval selects exactly on both sides
(``approx_topk=False``). Answers, retrieved chunks and highlights must be
equal, and every highlight must index its chunk verbatim.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

import jax

from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine.embedding_providers import (
    HashedBowDenseProvider as JaxDense,
    HashedSparseProvider as JaxSparse,
)
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny_config
from verbatim_rag_tpu.models.highlighter import (
    ModelSpanExtractor as JaxExtractor,
    init_highlighter_params,
)
from verbatim_rag_tpu.rag import VerbatimRAG as JaxRAG
from verbatim_rag_tpu_torch.engine import (
    HashedBowDenseProvider,
    HashedSparseProvider,
    VerbatimIndex,
)
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models.config import tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor, params_from_jax
from verbatim_rag_tpu_torch.rag import VerbatimRAG

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))
QUESTIONS = [
    "How efficient are solar panels?",
    "Where do offshore wind farms get steadier wind?",
    "How is energy stored for the night?",
]
OVERRIDES = dict(
    vocab_size=1024,
    hidden_size=32,
    num_heads=2,
    num_layers=3,
    intermediate_size=32,
    max_position_embeddings=8192,
    position_embedding_type="rope",
    norm_location="pre",
    activation="geglu",
    use_bias=False,
    final_norm=True,
    type_vocab_size=0,
    first_layer_no_attn_norm=True,
    layer_norm_eps=1e-5,
    local_attention_window=16,
    use_flash_attention=True,
)


@pytest.fixture(scope="module")
def responses():
    params = init_highlighter_params(jax.random.PRNGKey(3), jax_tiny_config(**OVERRIDES))
    jax_index = JaxIndex(dense_provider=JaxDense(), sparse_provider=JaxSparse(), approx_topk=False)
    jax_index.add_documents([JaxSchema.from_file(str(p)) for p in DOCS])
    jax_rag = JaxRAG(
        jax_index, extractor=JaxExtractor(params=params, config=jax_tiny_config(**OVERRIDES))
    )

    index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(),
        sparse_provider=HashedSparseProvider(),
        device="cpu",
    )
    index.add_documents([DocumentSchema.from_file(str(p)) for p in DOCS])
    extractor = ModelSpanExtractor(
        params=params_from_jax(jax.tree.map(np.asarray, params)),
        config=tiny_test_config(**OVERRIDES),
        device="cpu",
    )
    rag = VerbatimRAG(index, extractor=extractor)
    return [(rag.query(q), jax_rag.query(q)) for q in QUESTIONS]


def _view(response):
    return [
        (d.content, d.title, [(h.start, h.end, h.text) for h in d.highlights])
        for d in response.documents
    ]


@pytest.mark.parametrize("i", range(len(QUESTIONS)))
def test_same_answer_and_highlights_as_jax(responses, i):
    got, expected = responses[i]
    assert got.answer == expected.answer
    assert _view(got) == _view(expected)
    assert [(c.text, c.doc_index, c.number, c.type) for c in got.structured_answer.citations] == [
        (c.text, c.doc_index, c.number, c.type) for c in expected.structured_answer.citations
    ]


@pytest.mark.parametrize("i", range(len(QUESTIONS)))
def test_highlights_are_verbatim(responses, i):
    got, _ = responses[i]
    assert any(d.highlights for d in got.documents)
    for doc in got.documents:
        for h in doc.highlights:
            assert doc.content[h.start : h.end] == h.text


def test_default_extractor_follows_the_index_device():
    index = VerbatimIndex(dense_provider=HashedBowDenseProvider(), device="cpu")
    rag = VerbatimRAG(index)
    assert rag.extractor.device.type == "cpu"
    assert index.inspect()["num_chunks"] == 0


@pytest.mark.parametrize("option", ["int4", "mesh"])
def test_unported_options_raise(option):
    """The index's int4 tier and a mesh, which earlier slices refused, now
    answer like the JAX package's index with the same option: the same
    chunks in the same order, scores at rtol 5e-4. Rerankers
    (test_torch_rerankers.py), LLM clients, intent detectors and structured
    mode (test_torch_llm.py) are ported too."""
    from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from verbatim_rag_tpu_torch.parallel import make_mesh

    if option == "int4":
        jax_kw = port_kw = dict(dense_dtype="int4", sketch_dtype="int4")
    else:
        jax_kw = dict(mesh=jax_make_mesh(dp=2, tp=2, devices=jax.devices()[:4]))
        port_kw = dict(mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4))
    jax_index = JaxIndex(dense_provider=JaxDense(), sparse_provider=JaxSparse(), approx_topk=False, **jax_kw)
    port_index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(),
        approx_topk=False, **({"device": "cpu"} if option == "int4" else {}), **port_kw,
    )
    jax_index.add_documents([JaxSchema.from_file(str(p)) for p in DOCS])
    port_index.add_documents([DocumentSchema.from_file(str(p)) for p in DOCS])
    for question in QUESTIONS:
        got, want = port_index.query(question, k=4), jax_index.query(question, k=4)
        assert [h.text for h in got] == [h.text for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=5e-4, atol=5e-4)


def test_a_reranker_is_accepted():
    index = VerbatimIndex(dense_provider=HashedBowDenseProvider(), device="cpu")
    reranker = object()
    assert VerbatimRAG(index, extractor=object(), reranker=reranker).reranker is reranker
