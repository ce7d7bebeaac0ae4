"""Persistence in the PyTorch port vs the JAX package: an index saved by
either package loads in the other.

Stores: the same records go into a JAX store and a port store; each saves,
and each file is loaded by the other package. Then:
- the two packages' files hold the same arrays (``dense`` rows, int8 codes
  and scales, forward indexes, full-text statistics: equal) and the same
  ``config`` (``json.load`` equal key for key, in the same order), so
  ``cls(**config)`` builds the same store on either side;
- a file loaded by the other package answers like the store that saved it:
  rows equal, RRF scores bit-equal, single-method scores at rtol 1e-5; int8
  codes restored bit-equal.
`VerbatimIndex.save` / `load` go both ways with the hashed providers and with
seed-only neural providers (rebuilt from their identity with the JAX
package's weights: embeddings within 5e-4). The CLI's ``index``, ``query``
and ``template`` print what the JAX CLI prints and write the same files,
both extractors holding one set of tiny weights.
"""

from __future__ import annotations

import itertools
import json
import uuid
from pathlib import Path

import jax
import numpy as np
import pytest

from test_torch_full_text import FT, _ask, _corpus, _same, native_scanner  # noqa: F401
from test_torch_pipeline import OVERRIDES
from verbatim_rag_tpu.engine import VerbatimIndex as JaxIndex
from verbatim_rag_tpu.engine.embedding_providers import (
    HashedBowDenseProvider as JaxDense,
    HashedSparseProvider as JaxSparse,
)
from verbatim_rag_tpu.engine.store import DeviceVectorStore as JaxStore
from verbatim_rag_tpu.ingestion.schema import DocumentSchema as JaxSchema
from verbatim_rag_tpu.models import highlighter as jax_highlighter
from verbatim_rag_tpu.models import providers as jax_providers
from verbatim_rag_tpu.models.config import minilm_config as jax_minilm
from verbatim_rag_tpu.models.config import tiny_test_config as jax_tiny
from verbatim_rag_tpu.rag import cli as jax_cli
from verbatim_rag_tpu_torch.engine import HashedBowDenseProvider, HashedSparseProvider, VerbatimIndex
from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore
from verbatim_rag_tpu_torch.ingestion.schema import DocumentSchema
from verbatim_rag_tpu_torch.models import highlighter
from verbatim_rag_tpu_torch.models import providers
from verbatim_rag_tpu_torch.models.config import minilm_config, tiny_test_config
from verbatim_rag_tpu_torch.rag import cli

pytestmark = pytest.mark.usefixtures("native_scanner")

DOCS = sorted((Path(__file__).resolve().parent.parent / "examples" / "example_docs").glob("*.md"))

CONFIGS = {
    "bf16_full_text": dict(rescore_depth=128),
    "int8_section": dict(dense_dtype="int8", sketch_dtype="int8", approx_topk=True, block=8192,
                         rescore_depth=100),
    "exact": dict(sparse_mode="exact"),
    "narrow_float32": dict(dense_dtype="float32", sparse_ids_dtype="int16",
                           sparse_weight_dtype="float16", auto_compact_threshold=0.5),
}
METHODS = [("dense", "sparse", "full_text"), ("full_text",), ("sparse",), ("dense",)]


@pytest.fixture(autouse=True)
def _section_interpret(monkeypatch):
    monkeypatch.setenv("VERBATIM_SECTION_INTERPRET", "1")


def _filled(cls, records, **options):
    kwargs = {**FT, **options}
    store = cls(**kwargs) if cls is JaxStore else cls(device="cpu", **kwargs)
    store.add_vectors(records[:50])
    store.flush()
    store.add_vectors(records[50:])
    store.delete(["r4", "r30", "r61"])
    return store


def _load(cls, path):
    return cls.load(path) if cls is JaxStore else cls.load(path, device="cpu")


def _assert_answers_alike(got_store, expected_store, records):
    for methods in METHODS:
        got = _ask(got_store, records, methods, top_k=6)
        expected = _ask(expected_store, records, methods, top_k=6)
        assert any(got)
        _same(got, expected, exact_scores=len(methods) > 1)
        assert not {"r4", "r30", "r61"} & {h.id for r in got for h in r}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_both_packages_write_the_same_files(tmp_path, name):
    records = _corpus(80)
    for cls, tag in ((JaxStore, "jax"), (DeviceVectorStore, "port")):
        _filled(cls, records, **CONFIGS[name]).save(str(tmp_path / tag))
    metas = [json.load(open(tmp_path / f"{tag}.json")) for tag in ("jax", "port")]
    assert list(metas[1]["config"].items()) == list(metas[0]["config"].items())
    assert metas[1] == metas[0]
    arrays = [np.load(tmp_path / f"{tag}.npz") for tag in ("jax", "port")]
    assert sorted(arrays[1].files) == sorted(arrays[0].files)
    for key in arrays[0].files:
        assert arrays[1][key].dtype == arrays[0][key].dtype, key
        if key != "dense" or name != "bf16_full_text":
            np.testing.assert_array_equal(arrays[1][key], arrays[0][key], err_msg=key)
    if "dense" in arrays[0].files:  # float32 rows of the stored bf16 / int8 rows
        np.testing.assert_allclose(arrays[1]["dense"], arrays[0]["dense"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("saver,loader", [(JaxStore, DeviceVectorStore), (DeviceVectorStore, JaxStore)])
def test_a_saved_store_loads_in_the_other_package(tmp_path, name, saver, loader):
    records = _corpus(80)
    saved = _filled(saver, records, **CONFIGS[name])
    saved.save(str(tmp_path / "idx"))
    loaded = _load(loader, str(tmp_path / "idx"))
    same_side = _load(saver, str(tmp_path / "idx"))
    assert loaded.count() == same_side.count() == 77
    assert loaded.candidate_impl == same_side.candidate_impl
    if saved.dense_dtype == "int8":
        codes = np.load(tmp_path / "idx.npz")["dense_i8"]
        np.testing.assert_array_equal(np.asarray(loaded._dense[: len(codes)]), codes)
        np.testing.assert_array_equal(np.asarray(same_side._dense[: len(codes)]), codes)
    np.testing.assert_array_equal(np.asarray(loaded._doc_freq), np.asarray(same_side._doc_freq))
    _assert_answers_alike(loaded, same_side, records)


def test_load_with_a_mesh_raises_and_missing_files_raise(tmp_path):
    """Loading onto a mesh is ported (`tests/test_torch_mesh_store.py`); a
    missing file still raises."""
    _filled(DeviceVectorStore, _corpus(60)).save(str(tmp_path / "idx"))
    with pytest.raises(FileNotFoundError):
        DeviceVectorStore.load(str(tmp_path / "missing"), device="cpu")


# -- VerbatimIndex ---------------------------------------------------------------------------

QUESTIONS = ["How efficient are solar panels?", "Where do offshore wind farms get steadier wind?"]


def _index_results(index, **kwargs):
    return [[(h.id, h.score) for h in row] for row in index.query_batch(QUESTIONS, k=4, **kwargs)]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_round_trip_with_hashed_providers(tmp_path, direction):
    path = str(tmp_path / "idx")
    kw = dict(enable_full_text=True, full_text_vocab=4096, approx_topk=False)
    if direction == "jax_to_port":
        saved = JaxIndex(dense_provider=JaxDense(), sparse_provider=JaxSparse(), **kw)
        saved.add_documents([JaxSchema.from_file(str(p)) for p in DOCS])
        saved.save(path)
        loaded = VerbatimIndex.load(path, device="cpu")
    else:
        saved = VerbatimIndex(
            dense_provider=HashedBowDenseProvider(), sparse_provider=HashedSparseProvider(),
            device="cpu", **kw,
        )
        saved.add_documents([DocumentSchema.from_file(str(p)) for p in DOCS])
        saved.save(path)
        loaded = JaxIndex.load(path)
    assert loaded.documents == saved.documents and loaded.enable_full_text
    assert type(loaded.dense_provider).__name__ == "HashedBowDenseProvider"
    for weights in (None, {"dense": 0.4, "sparse": 0.3, "full_text": 0.3}):
        assert _index_results(loaded, hybrid_weights=weights) == _index_results(saved, hybrid_weights=weights)


NEURAL = dict(hidden_size=64, num_heads=2, num_layers=2, intermediate_size=128, vocab_size=1024,
              max_position_embeddings=128, compute_dtype="float32")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_round_trip_with_neural_providers(tmp_path, direction):
    """Seed-only neural identities: the loading package rebuilds the
    providers from ``(config, seed)`` and gets the saving package's weights."""
    path = str(tmp_path / "idx")
    texts = [DocumentSchema.from_file(str(p)).content for p in DOCS]
    if direction == "jax_to_port":
        dense = jax_providers.JaxDenseProvider(config=jax_minilm(**NEURAL), max_length=128, batch_size=4, seed=5)
        sparse = jax_providers.JaxSpladeProvider(config=jax_minilm(**NEURAL), max_length=128, batch_size=4,
                                                 max_nnz=32, seed=6)
        saved = JaxIndex(dense_provider=dense, sparse_provider=sparse, approx_topk=False)
        saved.add_documents([JaxSchema.from_file(str(p)) for p in DOCS])
        saved.save(path)
        loaded = VerbatimIndex.load(path, device="cpu")
    else:
        dense = providers.JaxDenseProvider(config=minilm_config(**NEURAL), max_length=128, batch_size=4,
                                           seed=5, device="cpu")
        sparse = providers.JaxSpladeProvider(config=minilm_config(**NEURAL), max_length=128, batch_size=4,
                                             max_nnz=32, seed=6, device="cpu")
        saved = VerbatimIndex(dense_provider=dense, sparse_provider=sparse, approx_topk=False, device="cpu")
        saved.add_documents([DocumentSchema.from_file(str(p)) for p in DOCS])
        saved.save(path)
        loaded = JaxIndex.load(path)
    assert loaded.dense_provider.describe() == saved.dense_provider.describe()
    np.testing.assert_allclose(
        loaded.dense_provider.embed_batch(texts), saved.dense_provider.embed_batch(texts), atol=5e-4
    )
    got, expected = _index_results(loaded), _index_results(saved)
    assert [[i for i, _ in row] for row in got] == [[i for i, _ in row] for row in expected]
    for g_row, e_row in zip(got, expected):
        np.testing.assert_allclose([s for _, s in g_row], [s for _, s in e_row], rtol=1e-6)


# -- the CLI -------------------------------------------------------------------------------------


@pytest.fixture
def tiny_extractors(monkeypatch):
    """Both packages' default extractor becomes the tiny highlighter with one
    set of weights (the JAX init, converted with `params_from_jax`)."""
    params = jax_highlighter.init_highlighter_params(jax.random.PRNGKey(3), jax_tiny(**OVERRIDES))
    state = highlighter.params_from_jax(jax.tree.map(np.asarray, params))
    jax_cls, port_cls = jax_highlighter.ModelSpanExtractor, highlighter.ModelSpanExtractor
    monkeypatch.setattr(
        jax_highlighter, "ModelSpanExtractor",
        lambda **kw: jax_cls(params=params, config=jax_tiny(**OVERRIDES), **kw),
    )
    monkeypatch.setattr(
        highlighter, "ModelSpanExtractor",
        lambda device=None, **kw: port_cls(params=state, config=tiny_test_config(**OVERRIDES),
                                           device=device, **kw),
    )


@pytest.fixture
def counted_ids(monkeypatch):
    """Document and chunk ids from a counter instead of random uuids, so two
    ingests of the same files name their records alike; ``reset()`` restarts
    the count."""
    counter = {"it": itertools.count()}
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter["it"])))

    def reset():
        counter["it"] = itertools.count()

    return reset


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("sparse", [False, True])
def test_cli_index_and_query_print_what_the_jax_cli_prints(
    tmp_path, capsys, monkeypatch, tiny_extractors, counted_ids, sparse
):
    monkeypatch.chdir(tmp_path)
    docs = str(DOCS[0].parent)
    outputs = {}
    for tag, main, device in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        counted_ids()
        flags = ["--sparse"] if sparse else []
        out = _run(main, ["index", docs, "--db", f"{tag}/idx", *flags, *device], capsys)
        outputs[tag] = [out.replace(f"{tag}/idx", "<db>")]
        for question in QUESTIONS:
            out = _run(main, ["query", question, "--db", f"{tag}/idx", "--json", f"{tag}.json", *device], capsys)
            outputs[tag].append(out.replace(f"{tag}.json", "<json>"))
            outputs[tag].append(json.load(open(f"{tag}.json")))
    assert outputs["port"] == outputs["jax"]
    response = outputs["port"][2]
    assert response["documents"] and all(
        d["content"][h["start"] : h["end"]] == h["text"] for d in response["documents"] for h in d["highlights"]
    )
    for suffix in (".json", ".docs.json", ".providers.json"):
        assert json.load(open(f"port/idx{suffix}")) == json.load(open(f"jax/idx{suffix}"))


def test_cli_template_and_llm(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outputs = {}
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        path = f"{tag}.json"
        outputs[tag] = [
            _run(main, ["template", "--templates", path, "--set-static", "Custom: [DISPLAY_SPANS]"], capsys)
            .replace(path, "<t>"),
            _run(main, ["template", "--templates", path, "--show"], capsys),
            json.load(open(path)),
        ]
        assert main(["template", "--templates", path]) == 1
    assert outputs["port"] == outputs["jax"]
    # ``--llm`` is taken as the JAX CLI takes it: the index loads first, so a
    # missing one fails the same way (the answer itself: test_torch_llm.py).
    failures = []
    for main, device in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(FileNotFoundError) as exc:
            main(["query", "q", "--db", "x", "--llm", "--model", "m", *device])
        failures.append(str(exc.value))
    assert failures[0] == failures[1]


def test_compact_and_load_keep_the_jax_slot_layout(tmp_path):
    """Forward-index rows ingested as arrays with zero weights between live
    slots: after `compact` and after save → `load` the rows are laid out as
    the JAX store lays them out (its term dicts drop the zeros and pad at
    the end)."""
    rng = np.random.default_rng(8)
    records = []
    for i in range(40):
        ids = rng.choice(np.arange(1, 500), size=16, replace=False).astype(np.int32)
        w = rng.random(16).astype(np.float32)
        w[rng.random(16) < 0.3] = 0.0
        records.append(dict(id=f"r{i}", text=f"row {i}", dense=rng.normal(size=32).astype(np.float32),
                            sparse_arrays=(ids, w)))
    kwargs = dict(dense_dim=32, sparse_vocab=500, sparse_max_nnz=16, projection_dim=64, block=1024)
    stores = [JaxStore(**kwargs), DeviceVectorStore(device="cpu", **kwargs)]
    for store in stores:
        store.add_vectors(records)
        store.delete(["r3", "r9"])
        assert store.compact() == 2
    for name in ("_sp_ids", "_sp_w"):
        np.testing.assert_array_equal(np.asarray(getattr(stores[1], name)), np.asarray(getattr(stores[0], name)))
    stores[0].save(str(tmp_path / "jax"))
    loaded = DeviceVectorStore.load(str(tmp_path / "jax"), device="cpu")
    reloaded = JaxStore.load(str(tmp_path / "jax"))
    for name in ("_sp_ids", "_sp_w"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)), np.asarray(getattr(reloaded, name)))
