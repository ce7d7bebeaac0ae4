"""The traffic generator repeats exactly from one seed, and every seed
gets the same sizes."""

import numpy as np

from portbench.harness import gen
from portbench.reference import tokenizer as ref_tok
from portbench.tests import cells


def test_rag_traffic_repeats_from_a_seed():
    spec = cells.tiny_rag()["traffic"]
    a = gen.rag_corpus(2**31 + 3, spec["corpus"])
    b = gen.rag_corpus(2**31 + 3, spec["corpus"])
    assert a["docs"] == b["docs"]
    assert gen.rag_questions(9, a, spec["questions"]) == gen.rag_questions(9, b, spec["questions"])
    c = gen.rag_corpus(2**31 + 4, spec["corpus"])
    assert c["docs"] != a["docs"]
    assert sorted(c["lengths"]) == sorted(a["lengths"])


def test_rag_sections_have_their_lengths_and_questions_their_sizes():
    for traffic in ("burst64", "longdocs16"):
        spec = cells.tiny_rag(traffic)["traffic"]
        corpus = gen.rag_corpus(1, spec["corpus"])
        assert [ref_tok.count_tokens(s) for s in corpus["sections"]] == list(corpus["lengths"])
        assert "".join(corpus["docs"]) == "".join(corpus["sections"])
        calls = gen.rag_questions(1, corpus, spec["questions"])
        assert len(calls) == spec["questions"]["batches"]
        sizes = sorted(ref_tok.count_tokens(q) for q in calls[0])
        for call in calls:
            assert sorted(ref_tok.count_tokens(q) for q in call) == sizes
            assert all(any(q[:-1] in " ".join(w) for w in corpus["words"]) for q in call)


def test_full_size_lengths():
    lengths = gen.section_lengths(
        {"dist": "lognormal", "median": 200, "p99": 2000, "min": 16, "cap": 7800}, 2048
    )
    assert int(np.median(lengths)) in (199, 200, 201)
    assert 1900 <= np.percentile(lengths, 99) <= 2100
    assert lengths.max() <= 7800


def test_bench_data_repeats_from_a_seed():
    a, b = gen.bench_data(2**31 + 9, 100, 8, 4, 50, 6, 4), gen.bench_data(2**31 + 9, 100, 8, 4, 50, 6, 4)
    assert np.array_equal(a["dense"], b["dense"]) and np.array_equal(a["ids"], b["ids"])
    qa, qb = a["queries"](3), b["queries"](3)
    assert all(np.array_equal(x, y) for x, y in zip((qa[0], *qa[1], qa[2]), (qb[0], *qb[1], qb[2])))


def test_burst_batches_pad_to_the_traffic_length(monkeypatch):
    """The batches a window cycles all pad the extractor's rows to the
    traffic's ``padded_length``, as the program's forward receives them."""
    from portbench.drivers.rag import Driver
    from portbench.harness import common
    from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor

    seen = []
    forward = ModelSpanExtractor._forward_probs

    def recorded(self, ids, mask):
        seen.append(tuple(ids.shape))
        return forward(self, ids, mask)

    monkeypatch.setattr(ModelSpanExtractor, "_forward_probs", recorded)
    cell = cells.tiny_rag("burst64")
    cell["traffic"]["questions"].update(padded_length=128, candidates=64, batches=3)
    driver = Driver(cell["cfg"], cell["traffic"], 5, "cpu", common.Spans("cpu", False))
    driver.setup()
    calls, shapes = driver.select_calls()
    assert len(calls) == 3 and {s[1] for s in shapes} == {128}
    seen.clear()
    for batch in calls:
        driver.rag.query_batch(batch, k=driver.k)
    assert seen == shapes
