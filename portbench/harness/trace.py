"""The traced window: ``torch.profiler`` over the measured calls, reduced to
the device's busy time (the union of its operations' intervals), each
operation's time by name, and the idle gaps by what the host was doing.

``busy_ms`` is a frozen copy of ``verbatim_rag_tpu_torch/utils/profiling.py``'s.
The Chrome trace is written under ``TMPDIR``, read once and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

#: Trace categories of operations that run on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host events that say what the host was doing in an idle gap.
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
WINDOW = "portbench.window"


def busy_ms(intervals) -> float:
    """Length in ms of the union of ``(start_us, duration_us)`` intervals."""
    total_us, end = 0.0, float("-inf")
    for start, duration in sorted(intervals):
        stop = start + duration
        if stop <= end:
            continue
        total_us += stop - max(start, end)
        end = stop
    return total_us / 1e3


class Trace:
    """Context manager: profiles its body when ``enabled``; ``record`` marks
    the window inside it. After exit, :meth:`summary` reduces the trace."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.events: list = []

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        self.prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                self.events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
        finally:
            os.remove(path)
        self.prof = None
        return False

    def window(self):
        """A span around the measured calls, by which the trace is cut."""
        import torch

        return torch.profiler.record_function(WINDOW)

    def summary(self, top: int = 10) -> dict:
        """busy_s, the device operations' seconds by name, each kernel
        interval (name, start µs, µs), and the idle gaps' seconds by the
        innermost host event running at their middle."""
        win = [e for e in self.events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window span")
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
        ops = []
        for e in self.events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            s, stop = max(s, t0), min(s + d, t1)
            if stop > s:
                ops.append((e.get("name", "?"), s, stop - s))
        by_name: dict[str, float] = defaultdict(float)
        for name, _, d in ops:
            by_name[name[:90]] += d / 1e6
        busy = busy_ms((s, d) for _, s, d in ops) / 1e3
        return dict(
            busy_s=busy,
            device_ops=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
            idle_gaps=self._gaps(ops, t0, t1, top),
            ops=ops,
        )

    def _gaps(self, ops, t0: float, t1: float, top: int) -> list:
        ends, gaps = t0, []
        for _, s, d in sorted(ops, key=lambda o: o[1]):
            if s > ends:
                gaps.append((ends, s))
            ends = max(ends, s + d)
        if t1 > ends:
            gaps.append((ends, t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:5000]
        host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?")[:90])
            for e in self.events
            if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
        )
        starts = np.array([h[0] for h in host])
        by_name: dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            name = "host, no traced op"
            # The innermost host event at the gap's middle: the latest to
            # start among those still running then.
            last = int(np.searchsorted(starts, mid, side="right")) - 1
            for i in range(last, max(-1, last - 4000), -1):
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
            by_name[name] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]

    def seconds_of(self, ops, needle: str) -> float:
        """Device seconds of the operations whose name holds ``needle``."""
        return sum(d for name, _, d in ops if needle in name) / 1e6
