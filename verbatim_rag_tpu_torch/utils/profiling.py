"""Tracing and per-stage timing (port of `verbatim_rag_tpu/utils/profiling.py`).

- :class:`StageTimer` (host code, copied) emits the streaming path's
  ``{"stage": ..., "elapsed_ms": ...}`` events. It reads the host clock
  only: a stage that launches kernels ends with :func:`synchronize`, or it
  measures their launch.
- :class:`DeviceTrace` / :func:`device_trace` run `torch.profiler` with CUDA
  activity and write a Chrome trace into ``log_dir``;
  :func:`trace_device_busy_ms` reads such a trace back as the milliseconds
  the card was busy: the union of its kernel intervals, not their sum.
- :func:`block_and_time` times one call between two device synchronizations.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import time
from dataclasses import dataclass, field

import torch

from verbatim_rag_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


def synchronize(device) -> None:
    """Wait for every stream of ``device`` when it is a CUDA device."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class StageTimer:
    """Accumulates named stage timings; renders streaming-style events."""

    stages: list[dict] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed_ms = int((time.perf_counter() - start) * 1000)
            self.stages.append({"stage": name, "elapsed_ms": elapsed_ms})
            logger.debug("stage %s: %d ms", name, elapsed_ms)

    def events(self) -> list[dict]:
        return [{"type": "progress", **s} for s in self.stages]

    def total_ms(self) -> int:
        return sum(s["elapsed_ms"] for s in self.stages)


class DeviceTrace:
    """A `torch.profiler` session over ``device`` that writes its Chrome
    trace to ``log_dir/trace.json`` when stopped.

    On a CUDA device it records CUDA activity only (every kernel of the
    process, whichever thread launched it); on the CPU it records CPU ops,
    and the trace holds no device time."""

    def __init__(self, log_dir: str, device=None):
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        self.device = resolve_device(device)
        activity = ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU
        self._profile = profile(activities=[activity])

    def start(self) -> None:
        synchronize(self.device)
        self._profile.start()

    def stop(self) -> str:
        """Stop, write the trace and return its path."""
        synchronize(self.device)
        self._profile.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, TRACE_FILE)
        self._profile.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """`torch.profiler` trace context; the Chrome trace lands in ``log_dir``
    (open it in Perfetto or `chrome://tracing`)."""
    trace = DeviceTrace(log_dir, device)
    trace.start()
    try:
        yield trace
    finally:
        trace.stop()


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


def trace_device_busy_ms(logdir: str) -> float:
    """Milliseconds the card was busy in the newest Chrome trace under
    ``logdir``: the union of its CUDA kernel intervals (overlapping kernels
    count once; the gaps between kernels, where the card waits for the host,
    do not count). Divide by the calls issued inside the trace for a per-call
    figure.

    Raises ``RuntimeError`` when ``logdir`` holds no trace."""
    paths = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    if not paths:
        raise RuntimeError(f"no Chrome trace under {logdir}")
    with open(max(paths, key=os.path.getmtime)) as fh:
        events = json.load(fh).get("traceEvents", [])
    return busy_ms(
        (float(e["ts"]), float(e["dur"]))
        for e in events
        if e.get("cat") == "kernel" and e.get("ph") == "X"
    )


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def block_and_time(fn, *args, readback: bool = True, device=None, **kwargs) -> tuple[float, object]:
    """Seconds of one ``fn(*args, **kwargs)`` on ``device`` (default: the
    current CUDA device), between a device synchronization before the call
    and one after it; ``readback`` also copies the result's first tensor to
    the host inside the timed region."""
    device = resolve_device(device)
    synchronize(device)
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize(device)
    leaf = _first_tensor(out)
    if readback and leaf is not None:
        leaf.cpu()
    return time.perf_counter() - start, out
