"""A run whose timed path is broken underneath reads ``correct`` false:
each fault a cell can have, planted where the answer is produced."""

import pytest

from portbench import run
from portbench.tests import cells

SEED = 2**31 + 5


def _run(cell):
    return run.run_cell(cell["cell"]["name"], SEED, 0.5, False, "cpu", cell)


def _shift_fused_rows(monkeypatch):
    """Every fused answer's rows moved to the next row: answers altered
    where the store produces them."""
    from verbatim_rag_tpu_torch.ops import hybrid

    fuse = hybrid.rrf_fuse_device

    def altered(*args, **kwargs):
        scores, rows = fuse(*args, **kwargs)
        return scores, (rows + 1).clamp(max=int(args[0].max()))

    monkeypatch.setattr(hybrid, "rrf_fuse_device", altered)


def _half_the_batch(monkeypatch, cls, method):
    """The second half of every batch left unanswered."""
    inner = getattr(cls, method)

    def halved(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        return out[: (len(out) + 1) // 2]

    monkeypatch.setattr(cls, method, halved)


@pytest.mark.parametrize("fault", ["answers", "half_batch"])
def test_hybrid_faults_are_caught(monkeypatch, fault):
    from verbatim_rag_tpu_torch.engine.store import DeviceVectorStore

    if fault == "answers":
        _shift_fused_rows(monkeypatch)
    else:
        _half_the_batch(monkeypatch, DeviceVectorStore, "query_batch")
    result = _run(cells.tiny_hybrid())
    assert not result["correct"]


@pytest.mark.parametrize("fault", ["answers", "half_batch", "probabilities", "tokens", "spans"])
def test_rag_faults_are_caught(monkeypatch, fault):
    from verbatim_rag_tpu_torch.models.highlighter import ModelSpanExtractor
    from verbatim_rag_tpu_torch.rag.core import VerbatimRAG

    if fault == "answers":
        _shift_fused_rows(monkeypatch)
    elif fault == "half_batch":
        _half_the_batch(monkeypatch, VerbatimRAG, "query_batch")
    elif fault == "probabilities":
        forward = ModelSpanExtractor._forward_probs

        def altered(self, ids, mask):
            probs = forward(self, ids, mask)
            probs[0, 3] += 0.05
            return probs

        monkeypatch.setattr(ModelSpanExtractor, "_forward_probs", altered)
    elif fault == "tokens":
        plan = ModelSpanExtractor._plan

        def altered(self, question, context):
            out = plan(self, question, context)
            out["rows"][0][-2] = 3 + (out["rows"][0][-2] + 1) % 500
            return out

        monkeypatch.setattr(ModelSpanExtractor, "_plan", altered)
    else:
        post = ModelSpanExtractor._postprocess_spans

        def altered(self, context, spans):
            return [(s + 1, e) for s, e in post(self, context, spans)]

        monkeypatch.setattr(ModelSpanExtractor, "_postprocess_spans", altered)
    result = _run(cells.tiny_rag())
    assert not result["correct"], result["checks"]
