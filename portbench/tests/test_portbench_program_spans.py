"""The readers of the program's own spans and counters (``harness/program.py``
and the five metrics on them) on a recorded window, and what they give
for a program that has neither."""

import json
from pathlib import Path

import pytest

from portbench import run
from portbench.harness import program
from portbench.harness.trace import Trace

RECORD = Path(__file__).with_name("program_record.json")
METRICS = ("store_idle_ms.search", "extract_idle_ms.rag", "extract_idle_ms.long", "row_pad_share.rag",
           "row_pad_share.long")


def _record(events=None):
    """The window 1000..4000 µs: two store calls with their stages, then the
    extractor's, inside the harness's span; device work between them."""
    data = json.loads(RECORD.read_text())
    tr = Trace(False)
    tr.events = data["trace_events"] if events is None else events
    s = tr.summary()
    rec = dict(data["record"], busy_s=s["busy_s"], ops=s["ops"], tracer=tr)
    return rec, s, data["counters"]


@pytest.fixture
def counters(monkeypatch):
    from verbatim_rag_tpu_torch.utils import profiling

    _, _, recorded = _record()
    monkeypatch.setattr(profiling, "counters", lambda: dict(recorded))
    return recorded


def test_idle_inside_the_programs_spans():
    rec, _, _ = _record()
    # Idle: 1200-1500, 1600-2100, 2200-2800, 2900-3300, 3500-3700, 3800-4000.
    assert program.idle_intervals(rec) == [
        (1200, 1500), (1600, 2100), (2200, 2800), (2900, 3300), (3500, 3700), (3800, 4000)]
    # The store's two calls: 1050-1900 and 2000-2950 (their stages inside).
    assert program.span_union(rec, "vrag.store.") == [(1050, 1900), (2000, 2950)]
    store_us = 300 + 300 + 100 + 600 + 50
    assert run.load_metric("store_idle_ms.search").read(rec) == pytest.approx(store_us / 1e3 / 2)
    # The extractor's stages 3000-3900: not its range before the window, not
    # the harness's span, not the device-side copy of a range.
    assert program.span_union(rec, "vrag.extract.") == [(3000, 3900)]
    extract_us = 300 + 200 + 100
    for name in ("extract_idle_ms.rag", "extract_idle_ms.long"):
        assert run.load_metric(name).read(rec) == pytest.approx(extract_us / 1e3 / 2)


def test_idle_gaps_are_named_by_program_stage():
    _, s, _ = _record()
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({
        "vrag.store.program": 300e-6, "vrag.store.materialize": 500e-6, "cudaMemcpyAsync": 600e-6,
        "vrag.extract.plan": 400e-6, "vrag.extract.decode": 400e-6,
    })


def test_row_pad_share_reads_the_counters(counters):
    rec, _, _ = _record()
    for name in ("row_pad_share.rag", "row_pad_share.long"):
        assert run.load_metric(name).read(rec) == pytest.approx(100.0 * 384 / 1024)
    assert program.counter_share("extract.rows", "extract.padded_rows") == pytest.approx(62.5)
    assert program.counter_share("extract.rows", "no.such") is None


def test_a_program_without_spans_or_counters_reads_none(monkeypatch):
    from verbatim_rag_tpu_torch.utils import profiling

    events = [e for e in json.loads(RECORD.read_text())["trace_events"] if not e["name"].startswith("vrag.")]
    rec, _, _ = _record(events)
    monkeypatch.delattr(profiling, "counters")
    for name in METRICS:
        assert run.load_metric(name).read(rec) is None
    monkeypatch.setattr(profiling, "counters", dict, raising=False)
    assert run.load_metric("row_pad_share.rag").read(rec) is None


def test_metrics_are_declared_for_their_cells():
    spec = json.loads((Path(run.ROOT) / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    cells = {
        "store_idle_ms.search": "hybrid-1m-bf16.b512",
        "extract_idle_ms.rag": "rag-modernbert-base.burst64",
        "extract_idle_ms.long": "rag-modernbert-base.longdocs16",
        "row_pad_share.rag": "rag-modernbert-base.burst64",
        "row_pad_share.long": "rag-modernbert-base.longdocs16",
    }
    for name, cell in cells.items():
        assert declared[name]["workloads"] == [cell]
        assert declared[name]["source"] == ("program_counter" if "share" in name else "program_span")
