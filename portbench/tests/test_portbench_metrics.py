"""Each per-layer metric reader on a recorded window, and the yardstick's
arithmetic."""

import json
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.harness import roofline
from portbench.harness.trace import Trace, busy_ms

RECORD = Path(__file__).with_name("record.json")


def _loop_pairs(lengths, seq, window):
    """``chip_smoke.py::attention_pairs`` as written there."""
    total = 0
    for n in lengths:
        n = int(n)
        if n <= 0:
            continue
        if window is None:
            total += seq * n
            continue
        half = window // 2
        total += sum(max(0, min(n - 1, i + half) - max(0, i - half) + 1) for i in range(seq))
    return total


@pytest.mark.parametrize("window", [None, 16, 128])
def test_attention_pairs_counts_as_the_loop(window):
    lengths = [0, 1, 7, 64, 65, 300]
    assert roofline.attention_pairs(lengths, 300, window) == _loop_pairs(lengths, 300, window)


def _trace():
    """A recorded window: two kernels overlapping, a copy, host events."""
    tr = Trace(False)
    tr.events = json.loads(RECORD.read_text())["trace_events"]
    return tr


def test_trace_summary():
    tr = _trace()
    s = tr.summary()
    # Window 1000..2000 µs: the rescore clipped to 1000-1100, the flash
    # kernels 1100-1300 and 1200-1400, the copy 1600-1700.
    assert s["busy_s"] == pytest.approx(500e-6)
    assert s["device_ops"][0][0] == "flash_fwd_wgmma_kernel<64>"
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(200e-6)  # 1400-1600, inside aten::mm
    assert gaps["host, no traced op"] == pytest.approx(300e-6)  # 1700-2000
    assert busy_ms([(0, 10), (5, 10), (30, 1)]) == pytest.approx(0.016)


def _record():
    tr = _trace()
    s = tr.summary()
    rec = json.loads(RECORD.read_text())["record"]
    rec.update(busy_s=s["busy_s"], ops=s["ops"], tracer=tr)
    rec["flash"] = [(tuple(shape), torch.tensor(lens), window) for shape, lens, window in rec["flash"]]
    ids, w = torch.ones((10, 4), dtype=torch.int32), torch.ones((10, 4))
    w[:, 3] = 0
    rec["rescore"] = [(torch.tensor([[0, 1, -1]]), ids, w, 2)]
    return rec


def test_rag_readers():
    rec = _record()
    read = {name: run.load_metric(name).read(rec) for name in (
        "encode_ms.rag", "retrieve_ms.rag", "extract_ms.rag", "pad_share.rag",
        "flash_fwd_roofline.rag", "mfu.rag", "device_idle.rag")}
    assert read["encode_ms.rag"] == pytest.approx((3.0 + 5.0) / 2)
    assert read["retrieve_ms.rag"] == pytest.approx(2.0)
    assert read["extract_ms.rag"] == pytest.approx(50.0)
    assert read["pad_share.rag"] == pytest.approx(75.0)
    bound_ms = roofline.flash_bound(2, 8, 2, 64, [8, 4], None) + roofline.flash_bound(2, 8, 2, 64, [8, 4], 4)
    assert read["flash_fwd_roofline.rag"] == pytest.approx(100 * bound_ms / 1e3 / 400e-6)
    assert read["mfu.rag"] == pytest.approx(100 * 1e9 / (1e-3 * roofline.PEAK_BF16_FLOPS))
    assert read["device_idle.rag"] == pytest.approx(50.0)
    for name in ("mfu.search", "gc_full_ms.search"):
        assert run.load_metric(name).read(rec) is None


def test_search_readers():
    rec = _record()
    rec.pop("model_flops")
    rec["spans"] = {}
    rec["candidate_flops_per_batch"] = 2e9
    read = {name: run.load_metric(name).read(rec) for name in (
        "kernel_ms.search", "rescore_roofline.search", "mfu.search", "device_idle.search", "gc_full_ms.search")}
    assert read["kernel_ms.search"] == pytest.approx(0.5 / 2)
    live_bound = roofline.rescore_bound(*rec["rescore"][0])[0]
    assert read["rescore_roofline.search"] == pytest.approx(100 * live_bound / 1e3 / 100e-6)
    assert read["mfu.search"] == pytest.approx(100 * 4e9 / (1e-3 * roofline.PEAK_BF16_FLOPS))
    assert read["gc_full_ms.search"] == pytest.approx(1.5)
    assert run.load_metric("encode_ms.rag").read(rec) is None
