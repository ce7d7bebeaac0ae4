"""Reranking in the PyTorch port vs the JAX package: the cross-encoder, the
reranker adapters and `VerbatimRAG(reranker=...)`.

Both sides hold one set of cross-encoder weights (JAX init, carried with
`params_from_jax`) at a narrow MiniLM shape (two heads of 32, float32), with
flash attention off and on (the port's kernel runs its plain version on the
CPU, JAX's Pallas kernel as its own tests run it). The RAGs are the
streaming tests' (hashed providers, exact selection, one tiny extractor).

Tolerances:
- `jax_prng.fold_in`: bit-equal; the seed's initial weights within rtol
  1e-5 (`jax_prng`'s normals);
- `cross_encoder_scores` and `JaxCrossEncoder.score`: rtol/atol 5e-4, for a
  seed-only identity too;
- reranked orders, `query` / `query_batch` / `query_async` responses and the
  stream's events (host-clock fields aside): equal;
- the HTTP adapters, through a mock transport with no network: the same
  requests and the same scores.
"""

from __future__ import annotations

import asyncio
import logging

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_streaming import DOCS, EXTRACTOR, _counted_ingest, assert_close, blank_clock
from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine.embedding_providers import HashedBowDenseProvider as JaxDense
from verbatim_rag_tpu.engine.embedding_providers import HashedSparseProvider as JaxSparse
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.models import reranker as jax_reranker
from verbatim_rag_tpu.models.config import minilm_config as jax_minilm
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny
from verbatim_rag_tpu.models.highlighter import ModelSpanExtractor as JaxExtractor
from verbatim_rag_tpu.models.highlighter import init_highlighter_params
from verbatim_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from verbatim_rag_tpu.rag import StreamingRAG as JaxStreamingRAG
from verbatim_rag_tpu.rag import VerbatimRAG as JaxRAG
from verbatim_rag_tpu.rag import rerankers as jax_rerankers
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import ModelSpanExtractor, jax_prng
from verbatim_rag_tpu_torch.models import reranker
from verbatim_rag_tpu_torch.models.config import minilm_config, tiny_test_config
from verbatim_rag_tpu_torch.models.highlighter import params_from_jax
from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer
from verbatim_rag_tpu_torch.rag import JaxReranker, StreamingRAG, VerbatimRAG
from verbatim_rag_tpu_torch.rag import rerankers

CE = dict(hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128, vocab_size=1024,
          max_position_embeddings=512, compute_dtype="float32")
K = 5
RERANK_K = 3
QUESTIONS = [
    "How efficient are solar panels?",
    "Where do offshore wind farms get steadier wind?",
    "How is energy stored for the night?",
]
PASSAGES = [
    "Solar panels convert sunlight into electricity.",
    "Offshore wind farms see steadier wind than those on land.",
    "",
    "Batteries store surplus energy for the night; grids balance demand.",
    "Photovoltaic efficiency is about twenty percent in production.",
]


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ce_params():
    return _tree(jax_reranker.init_cross_encoder_params(jax.random.PRNGKey(17), jax_minilm(**CE)))


def _cross_encoders(params, flash: bool, max_length: int = 128):
    theirs = jax_reranker.JaxCrossEncoder(
        params=params, config=jax_minilm(**CE, use_flash_attention=flash), max_length=max_length
    )
    ours = reranker.JaxCrossEncoder(
        params=params_from_jax(params), config=minilm_config(**CE, use_flash_attention=flash),
        max_length=max_length, device="cpu",
    )
    return ours, theirs


@pytest.mark.parametrize("seed,data", [(0, 0), (0, 1), (17, 1), (3, 2**32 - 1), (2**40 + 5, 9)])
def test_fold_in_matches_jax(seed, data):
    expected = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data), np.uint32)
    np.testing.assert_array_equal(jax_prng.fold_in(jax_prng.prng_key(seed), data), expected)


def test_init_cross_encoder_params_matches_jax(ce_params):
    got = jax_prng.init_cross_encoder_params(jax_prng.prng_key(17), minilm_config(**CE))
    flat_got, flat_expected = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ce_params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ce_params)
    for a, b in zip(flat_got, flat_expected):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("flash", [False, True])
def test_cross_encoder_scores_match_jax(ce_params, flash):
    ours, theirs = _cross_encoders(ce_params, flash)
    enc = ours.tokenizer.encode_batch([QUESTIONS[0]] * len(PASSAGES), pair=PASSAGES, max_length=128)
    import torch

    with torch.no_grad():
        got = reranker.cross_encoder_scores(
            ours.model, torch.from_numpy(enc.input_ids), torch.from_numpy(enc.attention_mask)
        ).numpy()
    expected = np.asarray(jax_reranker.cross_encoder_scores(
        ce_params, theirs.config, jnp.asarray(enc.input_ids), jnp.asarray(enc.attention_mask)
    ))
    assert got.shape == (len(PASSAGES),) and got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(ours.score(QUESTIONS[0], PASSAGES), theirs.score(QUESTIONS[0], PASSAGES),
                               rtol=5e-4, atol=5e-4)
    assert ours.score("q", []).shape == theirs.score("q", []).shape == (0,)
    # The pooled state is what the score head reads.
    from verbatim_rag_tpu_torch.models.encoder import compute_dtype

    pooled = ours.pooled(QUESTIONS[0], PASSAGES)
    assert pooled.shape == (len(PASSAGES), ours.config.hidden_size)
    with torch.no_grad():
        rescored = ours.model.score(torch.from_numpy(pooled), compute_dtype(ours.config))[:, 0].numpy()
    np.testing.assert_allclose(rescored, ours.score(QUESTIONS[0], PASSAGES), rtol=1e-6, atol=1e-6)
    assert ours.pooled("q", []).shape == (0, ours.config.hidden_size)


@pytest.mark.parametrize("seed", [0, 5])
def test_seed_only_cross_encoder_matches_jax(seed):
    ours = reranker.JaxCrossEncoder(config=minilm_config(**CE), seed=seed, device="cpu")
    theirs = jax_reranker.JaxCrossEncoder(config=jax_minilm(**CE), seed=seed)
    np.testing.assert_allclose(ours.score(QUESTIONS[1], PASSAGES), theirs.score(QUESTIONS[1], PASSAGES),
                               rtol=5e-4, atol=5e-4)


class Hit:
    def __init__(self, i, text, enhanced=None):
        self.id, self.text = i, text
        if enhanced is not None:
            self.enhanced_text = enhanced


HITS = [Hit(i, t, enhanced=f"{t} #{i}" if i % 2 else None) for i, t in enumerate(PASSAGES * 2)]


def _scripted(module):
    class Scripted(module.BaseReranker):
        """Scores by a fixed function of the text (with ties)."""

        def score(self, question, texts):
            return [float(len(t) % 7) for t in texts]

    return Scripted


@pytest.mark.parametrize("rerank_k", [0, 1, 3, 50])
@pytest.mark.parametrize("text_field", ["text", "enhanced_text"])
def test_base_reranker_head_and_tail_match_jax(rerank_k, text_field):
    ours = _scripted(rerankers)(rerank_k=rerank_k, text_field=text_field)
    theirs = _scripted(jax_rerankers)(rerank_k=rerank_k, text_field=text_field)
    got = [h.id for h in ours.rerank("q", HITS)]
    assert got == [h.id for h in theirs.rerank("q", HITS)]
    assert got[rerank_k:] == [h.id for h in HITS[rerank_k:]]
    assert [h.id for h in asyncio.run(ours.rerank_async("q", HITS))] == got
    assert ours.rerank("q", []) == []


@pytest.mark.parametrize("flash", [False, True])
def test_jax_reranker_order_matches_jax(ce_params, flash):
    ours, theirs = _cross_encoders(ce_params, flash)
    got = JaxReranker(cross_encoder=ours, rerank_k=4).rerank(QUESTIONS[0], HITS)
    expected = jax_rerankers.JaxReranker(cross_encoder=theirs, rerank_k=4).rerank(QUESTIONS[0], HITS)
    assert [h.id for h in got] == [h.id for h in expected]
    assert [h.id for h in got[4:]] == [h.id for h in HITS[4:]]


def test_jax_reranker_builds_a_seed_only_cross_encoder():
    ours = JaxReranker(rerank_k=2, config=minilm_config(**CE), seed=3, device="cpu")
    theirs = jax_rerankers.JaxReranker(rerank_k=2, config=jax_minilm(**CE), seed=3)
    assert isinstance(ours.cross_encoder, reranker.JaxCrossEncoder)
    assert [h.id for h in ours.rerank("wind", HITS)] == [h.id for h in theirs.rerank("wind", HITS)]


# -- VerbatimRAG(reranker=...) ---------------------------------------------------------------


class Failing(rerankers.Reranker):
    def rerank(self, question, results):
        raise RuntimeError("reranker down")


class JaxFailing(jax_rerankers.Reranker):
    def rerank(self, question, results):
        raise RuntimeError("reranker down")


@pytest.fixture(scope="module")
def rags(ce_params):
    params = init_highlighter_params(jax.random.PRNGKey(13), jax_tiny(**EXTRACTOR))
    jax_index = JaxIndex(dense_provider=JaxDense(dim=64), sparse_provider=JaxSparse(), approx_topk=False)
    _counted_ingest(jax_index, [JaxSchema.from_file(str(p)) for p in DOCS])
    index = VerbatimIndex(
        dense_provider=HashedBowDenseProvider(dim=64), sparse_provider=HashedSparseProvider(), device="cpu"
    )
    _counted_ingest(index, [DocumentSchema.from_file(str(p)) for p in DOCS])
    jax_extractor = JaxExtractor(params=params, config=jax_tiny(**EXTRACTOR))
    extractor = ModelSpanExtractor(
        params=params_from_jax(_tree(params)), config=tiny_test_config(**EXTRACTOR), device="cpu"
    )
    ours_ce, theirs_ce = _cross_encoders(ce_params, flash=True)
    return {
        "jax": JaxRAG(jax_index, extractor=jax_extractor, k=K,
                      reranker=jax_rerankers.JaxReranker(cross_encoder=theirs_ce, rerank_k=RERANK_K)),
        "port": VerbatimRAG(index, extractor=extractor, k=K,
                            reranker=JaxReranker(cross_encoder=ours_ce, rerank_k=RERANK_K)),
        "jax_plain": JaxRAG(jax_index, extractor=jax_extractor, k=K),
        "port_plain": VerbatimRAG(index, extractor=extractor, k=K),
        "jax_failing": JaxRAG(jax_index, extractor=jax_extractor, k=K, reranker=JaxFailing()),
        "port_failing": VerbatimRAG(index, extractor=extractor, k=K, reranker=Failing()),
    }


def _dump(response):
    return response.model_dump()


def test_reranked_query_matches_jax(rags):
    for question in QUESTIONS:
        got = _dump(rags["port"].query(question))
        assert_close(got, _dump(rags["jax"].query(question)))
        retrieved = [d["content"] for d in _dump(rags["port_plain"].query(question))["documents"]]
        reranked = [d["content"] for d in got["documents"]]
        assert sorted(reranked[:RERANK_K]) == sorted(retrieved[:RERANK_K])
        assert reranked[RERANK_K:] == retrieved[RERANK_K:]
    assert any(
        [d["content"] for d in _dump(rags["port"].query(q))["documents"]]
        != [d["content"] for d in _dump(rags["port_plain"].query(q))["documents"]]
        for q in QUESTIONS
    ), "the reranker reordered nothing"


def test_reranked_query_batch_matches_jax(rags):
    got = [_dump(r) for r in rags["port"].query_batch(QUESTIONS)]
    assert_close(got, [_dump(r) for r in rags["jax"].query_batch(QUESTIONS)])
    assert got == [_dump(rags["port"].query(q)) for q in QUESTIONS]


def test_reranked_query_async_matches_jax(rags):
    async def both():
        return await asyncio.gather(
            *(rags["port"].query_async(q) for q in QUESTIONS),
            *(rags["jax"].query_async(q) for q in QUESTIONS),
        )

    out = [_dump(r) for r in asyncio.run(both())]
    assert_close(out[: len(QUESTIONS)], out[len(QUESTIONS):])
    assert out[: len(QUESTIONS)] == [_dump(rags["port"].query(q)) for q in QUESTIONS]


@pytest.mark.parametrize("question", QUESTIONS[:2])
def test_reranked_stream_matches_jax(rags, question):
    got = blank_clock(StreamingRAG(rags["port"]).stream_query_sync(question))
    expected = blank_clock(JaxStreamingRAG(rags["jax"]).stream_query_sync(question))
    assert_close(got, expected)
    assert [e["type"] for e in got] == ["documents", "progress", "highlights", "answer"]
    assert [t["stage"] for t in got[-1]["timings"]] == ["retrieve", "rerank", "extract", "highlight", "template"]
    assert got[-1]["data"] == _dump(rags["port"].query(question))


def test_a_failing_reranker_keeps_retrieval_order(rags, caplog):
    """As in the JAX package: the warning is logged and the answer is the
    one without a reranker, on every entry point and in the stream."""
    caplog.set_level(logging.WARNING)
    for question in QUESTIONS[:2]:
        plain = _dump(rags["port_plain"].query(question))
        assert _dump(rags["port_failing"].query(question)) == plain
        assert _dump(asyncio.run(rags["port_failing"].query_async(question))) == plain
        assert_close(plain, _dump(rags["jax_failing"].query(question)))
        events = StreamingRAG(rags["port_failing"]).stream_query_sync(question)
        expected = JaxStreamingRAG(rags["jax_failing"]).stream_query_sync(question)
        assert_close(blank_clock(events), blank_clock(expected))
        assert events[-1]["data"] == plain
    assert [_dump(r) for r in rags["port_failing"].query_batch(QUESTIONS)] == [
        _dump(rags["port_plain"].query(q)) for q in QUESTIONS
    ]
    failures = [r for r in caplog.records if "Reranker failed" in r.getMessage()
                and r.name.startswith("verbatim_rag_tpu_torch.")]
    assert len(failures) == 2 * 2 + 2 + len(QUESTIONS)


# -- HTTP adapters -------------------------------------------------------------------------


def _mock_post(monkeypatch, status=200, results=None):
    """Route `httpx.post` through a MockTransport; return the requests seen."""
    seen = []

    def handler(request: httpx.Request) -> httpx.Response:
        import json

        seen.append((str(request.url), request.headers["authorization"], json.loads(request.content)))
        return httpx.Response(status, json={"results": results or []})

    client = httpx.Client(transport=httpx.MockTransport(handler))

    def post(url, **kwargs):
        kwargs.pop("timeout", None)
        return client.post(url, **kwargs)

    monkeypatch.setattr(httpx, "post", post)
    return seen


RESULTS = [{"index": 2, "relevance_score": 0.9}, {"index": 0, "relevance_score": 0.4},
           {"index": 99, "relevance_score": 1.0}, {"index": -1, "relevance_score": 5.0}]


@pytest.mark.parametrize("name", ["CohereReranker", "JinaReranker"])
def test_http_adapters_match_jax(monkeypatch, name):
    seen = _mock_post(monkeypatch, results=RESULTS)
    kw = dict(api_key="k", rerank_k=4, api_base="http://rerank.invalid/v1/")
    ours, theirs = getattr(rerankers, name)(**kw), getattr(jax_rerankers, name)(**kw)
    texts = [h.text for h in HITS[:4]]
    assert ours.score("q", texts) == theirs.score("q", texts) == [0.4, 0.0, 0.9, 0.0]
    assert [h.id for h in ours.rerank("q", HITS)] == [h.id for h in theirs.rerank("q", HITS)]
    assert len(seen) == 4 and seen[0] == seen[1] == seen[2] == seen[3]
    url, auth, body = seen[0]
    assert url == "http://rerank.invalid/v1/rerank" and auth == "Bearer k"
    assert body == {"model": ours.model, "query": "q", "documents": texts}


def test_http_adapter_errors_raise_like_jax(monkeypatch, rags):
    _mock_post(monkeypatch, status=503)
    kw = dict(api_key="k", api_base="http://rerank.invalid/v1")
    for module in (rerankers, jax_rerankers):
        with pytest.raises(httpx.HTTPStatusError):
            module.CohereReranker(**kw).score("q", ["a"])


class FakeJina:
    """`rerank` returns fewer items than it was given (a top_n cut)."""

    def rerank(self, question, texts, top_n):
        order = sorted(range(len(texts)), key=lambda i: (-len(texts[i]), i))[:2]
        return [{"index": i, "relevance_score": 1.0} for i in order]


@pytest.mark.parametrize("rerank_k", [3, 50])
def test_jina_v3_through_its_model_seam_matches_jax(rerank_k):
    ours = rerankers.JinaV3Reranker(rerank_k=rerank_k, _model_obj=FakeJina())
    theirs = jax_rerankers.JinaV3Reranker(rerank_k=rerank_k, _model_obj=FakeJina())
    got = [h.id for h in ours.rerank("q", HITS)]
    assert got == [h.id for h in theirs.rerank("q", HITS)] and sorted(got) == [h.id for h in HITS]
    assert ours.rerank("q", []) == []


def test_cross_encoder_tokenizes_like_jax(ce_params):
    ours, theirs = _cross_encoders(ce_params, flash=False, max_length=16)
    assert isinstance(ours.tokenizer, HashTokenizer) and isinstance(theirs.tokenizer, JaxHashTokenizer)
    a = ours.tokenizer.encode_batch(["q"] * 2, pair=PASSAGES[:2], max_length=16)
    b = theirs.tokenizer.encode_batch(["q"] * 2, pair=PASSAGES[:2], max_length=16)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_allclose(ours.score("q", PASSAGES), theirs.score("q", PASSAGES), rtol=5e-4, atol=5e-4)
