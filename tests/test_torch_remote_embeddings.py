"""The port's `OpenAIEmbeddingProvider` against the JAX package's, with no
network.

Both packages' providers POST to ``<api_base>/embeddings`` through
``httpx.post``, which these tests route to one `httpx.MockTransport`: an
OpenAI-compatible endpoint that answers each input with the hashed
bag-of-words vector of its text (`HashedBowDenseProvider` at the requested
width), in a shuffled ``data`` order with each item's ``index``. Held equal:
the requests each side sends (batching, headers, bodies), the vectors
(5e-4), `describe` (no key), the identity round trip, and an index saved by
the JAX package with this provider loaded by the port and queried to JAX's
answers.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import httpx
import numpy as np
import pytest

from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine import embedding_providers as jax_ep
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu_torch.engine import VerbatimIndex
from verbatim_rag_tpu_torch.engine import embedding_providers as ep
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))
API = "http://embeddings.invalid/v1"
WIDTHS = {"text-embedding-ada-002": 1536, "text-embedding-3-small": 1536, "text-embedding-3-large": 3072}
TEXTS = [f"text number {i} about solar panels and wind" for i in range(7)] + ["", "Ünïcode wörds"]


class Endpoint:
    """A mock ``/embeddings``: hashed vectors of the request's width, data
    shuffled (clients must sort by ``index``), every request logged."""

    def __init__(self, dims: dict[str, int]):
        self.dims = dims
        self.requests = []

    def __call__(self, request: httpx.Request) -> httpx.Response:
        body = json.loads(request.content)
        self.requests.append((str(request.url), request.headers["authorization"], body))
        embed = ep.HashedBowDenseProvider(dim=self.dims[body["model"]])
        data = [
            {"object": "embedding", "index": i, "embedding": embed.embed_text(t).tolist()}
            for i, t in enumerate(body["input"])
        ]
        random.Random(len(self.requests)).shuffle(data)
        return httpx.Response(200, json={"object": "list", "data": data, "model": body["model"]})


@pytest.fixture
def endpoint(monkeypatch):
    """Route ``httpx.post`` (both packages' providers call it) to the mock."""
    mock = Endpoint({**WIDTHS, "small-model": 48})
    client = httpx.Client(transport=httpx.MockTransport(mock))
    monkeypatch.setattr(httpx, "post", lambda url, **kw: client.post(url, **{k: v for k, v in kw.items() if k != "timeout"}))
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    return mock


@pytest.mark.parametrize("batch_size", [1, 4, 256])
def test_embed_batch_requests_and_vectors_match_jax(endpoint, batch_size):
    got = {}
    for tag, module in (("port", ep), ("jax", jax_ep)):
        provider = module.OpenAIEmbeddingProvider(
            model="small-model", api_base=API + "/", api_key="k-1", dimension=48, batch_size=batch_size
        )
        vectors = provider.embed_batch(TEXTS)
        got[tag] = (vectors, list(endpoint.requests), provider.embed_text(TEXTS[0]))
        endpoint.requests.clear()
    (ours, our_requests, one), (theirs, their_requests, their_one) = got["port"], got["jax"]
    assert ours.dtype == np.float32 and ours.shape == (len(TEXTS), 48)
    np.testing.assert_allclose(ours, theirs, atol=5e-4)
    np.testing.assert_allclose(ours, ep.HashedBowDenseProvider(48).embed_batch(TEXTS), atol=5e-4)
    np.testing.assert_allclose(one, their_one, atol=5e-4)
    assert our_requests == their_requests
    assert len(our_requests) == -(-len(TEXTS) // batch_size)
    assert {r[0] for r in our_requests} == {API + "/embeddings"} and our_requests[0][1] == "Bearer k-1"


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"model": "text-embedding-3-large"},
        {"model": "text-embedding-3-small", "dimension": 256},
        {"model": "custom", "api_base": "http://localhost:8080/v1/"},
        {"api_key": "secret-key"},
    ],
)
def test_defaults_describe_and_round_trip_match_jax(monkeypatch, kwargs):
    """Dimension defaults by model, a trailing slash dropped, the key from
    the argument, ``OPENAI_API_KEY`` or "EMPTY" and never in `describe`; the
    identity rebuilds the same provider in either package."""
    monkeypatch.setenv("OPENAI_API_KEY", "env-key")
    ours, theirs = ep.OpenAIEmbeddingProvider(**kwargs), jax_ep.OpenAIEmbeddingProvider(**kwargs)
    assert vars(ours) == vars(theirs)
    assert ours.get_dimension() == theirs.get_dimension()
    identity = ours.describe()
    assert identity == theirs.describe() and "api_key" not in json.dumps(identity)
    assert "secret-key" not in json.dumps(identity) and "env-key" not in json.dumps(identity)
    rebuilt = ep.provider_from_config(identity)
    assert type(rebuilt) is ep.OpenAIEmbeddingProvider and rebuilt.describe() == identity
    assert rebuilt.describe() == jax_ep.provider_from_config(identity).describe()


def _hits(index, questions, k=4):
    return [[(h.id, h.text, h.score) for h in row] for row in index.query_batch(questions, k=k)]


QUESTIONS = ["How efficient are solar panels?", "Where do offshore wind farms get steadier wind?", "storage"]


@pytest.mark.parametrize("model,dim", [("small-model", 48), ("text-embedding-3-large", None)])
def test_an_index_saved_by_jax_with_this_identity_loads_in_the_port(endpoint, tmp_path, model, dim):
    """The JAX package indexes the example documents through the provider
    and saves; the port loads the files (its `provider_from_config` rebuilds
    the remote provider, which the stub serves) and answers as JAX does."""
    path = str(tmp_path / "idx")
    saved = JaxIndex(
        dense_provider=jax_ep.OpenAIEmbeddingProvider(model=model, api_base=API, dimension=dim),
        sparse_provider=jax_ep.HashedSparseProvider(),
        approx_topk=False,
    )
    saved.add_documents([JaxSchema.from_file(str(p)) for p in DOCS])
    saved.save(path)
    loaded = VerbatimIndex.load(path, device="cpu")
    assert type(loaded.dense_provider) is ep.OpenAIEmbeddingProvider
    assert loaded.dense_provider.describe() == saved.dense_provider.describe()
    assert loaded.documents == saved.documents
    got, expected = _hits(loaded, QUESTIONS), _hits(saved, QUESTIONS)
    assert [[(i, t) for i, t, _ in row] for row in got] == [[(i, t) for i, t, _ in row] for row in expected]
    for g_row, e_row in zip(got, expected):
        np.testing.assert_allclose([s for *_, s in g_row], [s for *_, s in e_row], rtol=1e-6)
    dense_only = [[h.id for h in r] for r in loaded.query_batch(QUESTIONS, k=3, search_type="dense")]
    assert dense_only == [[h.id for h in r] for r in saved.query_batch(QUESTIONS, k=3, search_type="dense")]


def test_an_index_built_through_the_stub_equals_one_built_from_the_vectors(endpoint):
    """The port's index built through the endpoint holds the same rows and
    answers as one built from `HashedBowDenseProvider` directly."""
    docs = [DocumentSchema.from_file(str(p)) for p in DOCS]
    remote = VerbatimIndex(
        dense_provider=ep.OpenAIEmbeddingProvider(model="small-model", api_base=API, dimension=48),
        sparse_provider=ep.HashedSparseProvider(), device="cpu",
    )
    local = VerbatimIndex(
        dense_provider=ep.HashedBowDenseProvider(dim=48), sparse_provider=ep.HashedSparseProvider(),
        device="cpu",
    )
    for index in (remote, local):
        for i, doc in enumerate(docs):
            doc.id = f"doc-{i}"
        index.add_documents(docs)
    assert np.array_equal(remote.store._dense.float().numpy(), local.store._dense.float().numpy())
    strip = lambda rows: [[(h.text, h.score) for h in r] for r in rows]  # noqa: E731
    assert strip(remote.query_batch(QUESTIONS, k=4)) == strip(local.query_batch(QUESTIONS, k=4))
