"""The plain reference against the port, at small sizes on the CPU."""

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness import common, gen
from portbench.reference import encoder as ref_encoder
from portbench.reference import tokenizer as ref_tok
from portbench.reference.search import HybridReference
from portbench.tests import cells


def _corpus():
    spec = cells.tiny_rag()["traffic"]
    corpus = gen.rag_corpus(7, spec["corpus"])
    return corpus, gen.rag_questions(7, corpus, spec["questions"])


def test_tokenizer_matches_port():
    from verbatim_rag_tpu_torch.models.tokenizer import HashTokenizer

    corpus, calls = _corpus()
    texts = corpus["sections"][:8] + calls[0] + ["Mixed CASE, punctuation! and 42 digits?"]
    for vocab in (1000, 50368):
        tok = HashTokenizer(vocab_size=vocab)
        for text in texts:
            ids, offs = tok.tokenize_with_offsets(text)
            assert ref_tok.tokenize(text, vocab) == (ids, offs)
            for max_length in (8, 512):
                enc = tok.encode_batch([text], max_length=max_length)
                live = enc.input_ids[0][enc.attention_mask[0] == 1].tolist()
                assert ref_tok.framed(text, vocab, max_length) == live


def _arch(name):
    cfg = cells.tiny_rag()["cfg"]
    return ref_encoder.arch_of(cfg[name])


def test_modernbert_reference_matches_port():
    from portbench.drivers.rag import encoder_configs
    from verbatim_rag_tpu_torch.models.highlighter import HighlighterModel, token_relevance_probs

    arch = _arch("extractor")
    params = common.make_weights(ref_encoder.param_spec(arch, "classifier"), 3, "x", "cpu")
    config = encoder_configs(cells.tiny_rag()["cfg"])[0]
    config = type(config)(**{**config.__dict__, "compute_dtype": "float32"})
    model = HighlighterModel(config)
    model.load_state_dict(params)
    lengths = [5, 40, 129]
    ids = torch.zeros((3, 160), dtype=torch.long)
    mask = torch.zeros((3, 160), dtype=torch.long)
    rng = np.random.default_rng(0)
    rows = [rng.integers(3, arch["vocab"], size=n).tolist() for n in lengths]
    for i, row in enumerate(rows):
        ids[i, : len(row)] = torch.tensor(row)
        mask[i, : len(row)] = 1
    with torch.no_grad():
        got = token_relevance_probs(model, ids, mask)
        ref = ref_encoder.Reference(arch, params)
        for i, row in enumerate(rows):
            want = ref.token_probs(row)
            assert torch.allclose(got[i, : len(row)], want, atol=2e-6)


def test_minilm_references_match_port():
    from portbench.drivers.rag import encoder_configs
    from verbatim_rag_tpu_torch.models.encoder import Encoder, embed_texts
    from verbatim_rag_tpu_torch.models.splade import SpladeModel, splade_topk_terms

    arch = _arch("providers")
    config = encoder_configs(cells.tiny_rag()["cfg"])[1]
    config = type(config)(**{**config.__dict__, "compute_dtype": "float32"})
    rng = np.random.default_rng(1)
    row = [1] + rng.integers(3, arch["vocab"], size=30).tolist() + [2]
    ids = torch.tensor([row + [0] * 10])
    mask = torch.tensor([[1] * len(row) + [0] * 10])
    dense_p = common.make_weights(ref_encoder.param_spec(arch, "none"), 4, "d", "cpu")
    splade_p = common.make_weights(ref_encoder.param_spec(arch, "splade"), 4, "s", "cpu")
    enc, spl = Encoder(config), SpladeModel(config)
    enc.load_state_dict(dense_p)
    spl.load_state_dict(splade_p)
    with torch.no_grad():
        got = embed_texts(enc, ids, mask)[0]
        assert torch.allclose(got, ref_encoder.Reference(arch, dense_p).dense_embedding(row), atol=2e-6)
        t_ids, t_w = splade_topk_terms(spl, ids, mask, max_nnz=16)
        r_ids, r_w = ref_encoder.Reference(arch, splade_p).splade(row, 16)
        assert t_ids[0][t_w[0] > 0].tolist() == r_ids.tolist()
        assert torch.allclose(t_w[0][t_w[0] > 0], r_w, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_reference_matches_store(dtype):
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    d = gen.bench_data(5, 2000, 32, 16, 500, 24, 8)
    store = DeviceVectorStore(dense_dim=32, sparse_vocab=500, sparse_max_nnz=16, projection_dim=64,
                              rescore_depth=64, dense_dtype=dtype, device="cpu")
    store.add_vectors([{"id": str(i), "dense": d["dense"][i], "sparse_arrays": (d["ids"][i], d["weights"][i])}
                       for i in range(2000)])
    ref = HybridReference(torch.from_numpy(d["dense"]), torch.from_numpy(d["ids"]),
                          torch.from_numpy(d["weights"]), 500, 64, storage=dtype)
    q_dense, (q_ids, q_w), _ = d["queries"](0)
    out = store.query_batch(dense_queries=q_dense, sparse_queries=(q_ids, q_w), top_k=10)
    scores, rows = ref.search(torch.from_numpy(q_dense), torch.from_numpy(q_ids), torch.from_numpy(q_w), 10, 64)
    assert [[int(h.id) for h in r] for r in out] == rows.tolist()
    assert np.allclose([[h.score for h in r] for r in out], scores, atol=1e-7)


@pytest.mark.parametrize("which", ["hybrid", "burst64", "longdocs16"])
def test_driver_is_correct_on_the_cpu(which):
    cell = cells.tiny_hybrid() if which == "hybrid" else cells.tiny_rag(which)
    result = run.run_cell(cell["cell"]["name"], 2**31 + 11, 0.5, False, "cpu", cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell["end_to_end"]}
