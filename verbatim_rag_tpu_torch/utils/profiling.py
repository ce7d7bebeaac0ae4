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
- :func:`span` and :func:`count` are the program's own spans and counters at
  its layer boundaries (the store's and the extractor's stages, the entry
  points). They record only while a `torch.profiler` session runs
  (:func:`tracing`): each span is then a ``vrag.<name>`` range in the same
  Chrome trace as the kernels, on the clock the profiler aligns with the
  device's, and an entry of :func:`spans`; :func:`summary` and
  :func:`counters` read them back. With no profiler a span costs one flag
  check.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

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
        """Time the body as stage ``name``; while tracing it is also the
        span ``stream.<name>``."""
        with span("stream." + name):
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


# -- the program's spans and counters -------------------------------------------------

#: Spans kept in memory in one tracing session; later ones are counted under
#: ``trace.dropped_spans`` instead.
MAX_SPANS = 200_000

#: Prefix of the spans' ranges in a Chrome trace.
SPAN_PREFIX = "vrag."


class Span(NamedTuple):
    """One closed span: ``call`` is shared by the spans under one root span,
    ``parent`` is the enclosing span's name (None for a root), times are
    ``time.perf_counter_ns()``."""

    name: str
    call: int
    parent: str | None
    start_ns: int
    end_ns: int


class _Record:
    """What the spans and counters of the process recorded since the last
    :func:`reset`; the lock guards them against spans closed on several
    threads at once."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list[Span] = []
        self.counters: dict[str, float] = defaultdict(float)
        self.calls = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORD = _Record()


def tracing() -> bool:
    """True while a `torch.profiler` session records (in any thread)."""
    return _autograd_profiler._is_profiler_enabled


#: The span returned when nothing traces.
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "call", "parent", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _RECORD.stack()
        if stack:
            self.parent, self.call = stack[-1].name, stack[-1].call
        else:
            self.parent, self.call = None, next(_RECORD.calls)
        self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        _RECORD.stack().pop()
        self._range.__exit__(*exc)
        with _RECORD.lock:
            if len(_RECORD.spans) < MAX_SPANS:
                _RECORD.spans.append(Span(self.name, self.call, self.parent, self.start_ns, end_ns))
            else:
                _RECORD.counters["trace.dropped_spans"] += 1
        return False


def span(name: str):
    """Context manager: the body as span ``name`` while :func:`tracing`,
    else a shared object that does nothing. A span opened inside another
    on the same thread is its child and shares its call id; a root span
    opens a new call id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(name: str, value: float) -> None:
    """Add ``value`` to counter ``name``, only while :func:`tracing`."""
    if _autograd_profiler._is_profiler_enabled:
        with _RECORD.lock:
            _RECORD.counters[name] += value


def spans() -> list[Span]:
    """The spans closed while tracing since the last :func:`reset`."""
    with _RECORD.lock:
        return list(_RECORD.spans)


def counters() -> dict[str, float]:
    """The counters added while tracing since the last :func:`reset`."""
    with _RECORD.lock:
        return dict(_RECORD.counters)


def summary() -> dict[str, dict[str, float]]:
    """Per span name: ``count``, ``total_ms`` and ``self_ms`` (the total
    less the time of the spans opened directly inside it)."""
    out: dict[str, dict[str, float]] = {}
    children_ns: dict[str, int] = defaultdict(int)
    for s in spans():
        entry = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        entry["count"] += 1
        entry["total_ms"] += (s.end_ns - s.start_ns) / 1e6
        if s.parent is not None:
            children_ns[s.parent] += s.end_ns - s.start_ns
    for name, entry in out.items():
        entry["self_ms"] = entry["total_ms"] - children_ns[name] / 1e6
    return out


def reset() -> None:
    """Forget the recorded spans and counters."""
    with _RECORD.lock:
        _RECORD.spans.clear()
        _RECORD.counters.clear()


class DeviceTrace:
    """A `torch.profiler` session over ``device`` that writes its Chrome
    trace to ``log_dir/trace.json`` when stopped.

    It records the host's activity on every thread (CPU ops and the
    program's ``vrag.*`` spans, also those of a server's worker threads)
    and, on a CUDA device, CUDA activity beside it (every kernel of the
    process), so the spans lie on the kernels' timeline; on the CPU the
    trace holds no device time. Starting it clears :func:`spans` and
    :func:`counters`, so after :meth:`stop` they hold the session's."""

    def __init__(self, log_dir: str, device=None):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        self.device = resolve_device(device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profile = profile(
            activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)
        )

    def start(self) -> None:
        synchronize(self.device)
        reset()
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
