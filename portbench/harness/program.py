"""Readers of the program's own spans and counters
(``verbatim_rag_tpu_torch/utils/profiling.py``).

The program's spans leave ``vrag.<name>`` ranges (``user_annotation``
events) in the traced window's Chrome trace, on the kernels' clock; its
counters add up while the window's profiler records, so the warm-up is
not in them. A program without them gives no range and no counter, and
each reader then returns None.
"""

from __future__ import annotations

from portbench.harness.trace import WINDOW

#: Prefix of the program's span ranges in the trace.
PREFIX = "vrag."


def _merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted, disjoint ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def window(rec) -> tuple[float, float]:
    """(start, end) µs of the window span."""
    for e in rec["tracer"].events:
        if e.get("name") == WINDOW and e.get("cat") == "user_annotation":
            t0 = float(e["ts"])
            return t0, t0 + float(e["dur"])
    raise RuntimeError("the trace holds no window span")


def span_union(rec, prefix: str) -> list[tuple[float, float]]:
    """The union of the program's ranges whose name starts with ``prefix``
    (``vrag.store.``), clipped to the window, in µs."""
    t0, t1 = window(rec)
    spans = []
    for e in rec["tracer"].events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if min(b, t1) > max(a, t0):
                spans.append((max(a, t0), min(b, t1)))
    return _merged(spans)


def idle_intervals(rec) -> list[tuple[float, float]]:
    """The window's intervals in which no operation ran on the device: its
    complement of the union of the trace's kernel, copy and set intervals
    (``rec["ops"]``, already clipped to the window), in µs."""
    t0, t1 = window(rec)
    idle, at = [], t0
    for a, b in _merged((s, s + d) for _, s, d in rec["ops"]):
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if t1 > at:
        idle.append((at, t1))
    return idle


def overlap_us(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_ms(rec, stage: str):
    """ms a call in which the device ran nothing while the host was inside
    the program's spans ``vrag.<stage>*``, or None where the trace holds
    none of them."""
    spans = span_union(rec, PREFIX + stage)
    if not spans:
        return None
    return overlap_us(idle_intervals(rec), spans) / 1e3 / rec["calls"]


def counter_share(numerator: str, denominator: str):
    """% that the program's counter ``numerator`` is of ``denominator``, or
    None where the program keeps no such counters."""
    try:
        from verbatim_rag_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    got = counters()
    den = got.get(denominator)
    return 100.0 * got.get(numerator, 0.0) / den if den else None
