"""The one traffic generator: inputs made from the run's seed and a traffic
file's parameters.

- :func:`bench_data`: rows and query batches of the hybrid store, a frozen
  copy of ``chip_smoke.py::bench_data`` (each query is a row plus noise, half
  its terms taken from that row) with its sizes as arguments.
- :func:`rag_corpus` and :func:`question_batches`: markdown documents of
  ``## heading`` sections and the questions asked of them. Section lengths
  are a fixed set of quantiles of the traffic's length distribution, so
  every seed has the same sizes in another order; each question quotes a
  run of words of one target section.
"""

from __future__ import annotations

import itertools
import math
from statistics import NormalDist

import numpy as np


def bench_data(seed: int, rows: int, dim: int, nnz: int, vocab: int, batch: int, qm: int) -> dict:
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((rows, dim), dtype=np.float32)
    ids = rng.integers(1, vocab, size=(rows, nnz), dtype=np.int32)
    weights = rng.random((rows, nnz), dtype=np.float32)

    def queries(i):
        r = np.random.default_rng(seed + 1 + i)
        src = r.integers(0, rows, size=batch)
        q_dense = dense[src] + 0.5 * r.standard_normal((batch, dim), dtype=np.float32)
        q_ids = ids[src, :qm].copy()
        q_ids[:, qm // 2 :] = r.integers(1, vocab, size=(batch, qm - qm // 2))
        q_w = r.random((batch, qm), dtype=np.float32)
        return q_dense, (q_ids, q_w), src

    return dict(dense=dense, ids=ids, weights=weights, queries=queries)


def section_lengths(spec: dict, count: int) -> np.ndarray:
    """``count`` token lengths: the (i + ½)/count quantiles of a log-normal
    with the given median and 99th percentile, or evenly spaced over
    [low, high]; clipped to [min, cap]."""
    if spec["dist"] == "lognormal":
        sigma = math.log(spec["p99"] / spec["median"]) / NormalDist().inv_cdf(0.99)
        z = np.array([NormalDist().inv_cdf((i + 0.5) / count) for i in range(count)])
        lengths = spec["median"] * np.exp(sigma * z)
    else:
        lengths = np.linspace(spec["low"], spec["high"], count)
    return np.clip(np.rint(lengths), spec["min"], spec["cap"]).astype(int)


def _words(rng, size: int) -> list[str]:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lens = rng.integers(3, 10, size=size)
    chars = rng.integers(0, 26, size=int(lens.sum()))
    out, at = [], 0
    for n in lens:
        out.append("".join(letters[chars[at : at + n]]))
        at += n
    return out


def rag_corpus(seed: int, corpus: dict) -> dict:
    """Documents (markdown strings) and their sections in order. A section
    of L tokens is ``## `` and a three-word heading, then L - 5 tokens of
    Zipf-drawn words with a full stop every 8 to 16 words."""
    rng = np.random.default_rng([seed, 1])
    words = np.array(_words(rng, corpus["vocabulary"]), dtype=object)
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    p = ranks ** -corpus["zipf"]
    p /= p.sum()
    lengths = rng.permutation(section_lengths(corpus["lengths"], corpus["chunks"]))
    sections, tokens = [], []
    for length in lengths:
        body = words[rng.choice(len(words), size=int(length) - 5, p=p)].tolist()
        stops = np.cumsum(rng.integers(8, 17, size=len(body)))
        for at in stops[stops < len(body)][::-1]:
            body[at] = "."
        body[-1] = "."
        heading = words[rng.integers(0, len(words), size=3)].tolist()
        text = " ".join(body).replace(" .", ".")
        paras = text.split(". ")
        text = ".\n\n".join(". ".join(paras[i : i + 6]) for i in range(0, len(paras), 6))
        sections.append(f"## {' '.join(heading)}\n\n{text}\n\n")
        tokens.append(heading + [w for w in body if w != "."])
    per_doc = corpus["sections_per_doc"]
    docs = ["".join(sections[i : i + per_doc]) for i in range(0, len(sections), per_doc)]
    return dict(docs=docs, sections=sections, words=tokens, lengths=lengths)


def question_batches(seed: int, corpus: dict, spec: dict):
    """Batches of ``per_call`` questions without end. Question lengths are
    the same evenly spaced set in every batch; each quotes a run of words of
    a target section and ends with a question mark."""
    rng = np.random.default_rng([seed, 2])
    lo, hi = spec["tokens"]
    q_lens = np.rint(np.linspace(lo, hi, spec["per_call"])).astype(int)
    wordy = np.flatnonzero([len(w) >= hi for w in corpus["words"]])
    while True:
        targets = wordy[rng.integers(0, len(wordy), size=spec["per_call"])]
        out = []
        for t, n in zip(targets, rng.permutation(q_lens)):
            words = corpus["words"][t]
            start = int(rng.integers(0, len(words) - n + 2))
            out.append(" ".join(words[start : start + n - 1]) + "?")
        yield out


def rag_questions(seed: int, corpus: dict, spec: dict) -> list[list[str]]:
    """The first ``batches`` batches of :func:`question_batches`."""
    return list(itertools.islice(question_batches(seed, corpus, spec), spec["batches"]))
