"""What every driver shares: the weights made from the seed, synchronised
span timers around the program's calls, the comparison against limits and
the result line."""

from __future__ import annotations

import hashlib
import sys
import time

import torch

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "verbatim_rag_tpu")


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.blake2b(f"{seed}:{what}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def make_weights(spec, seed: int, what: str, device) -> dict[str, torch.Tensor]:
    """Float32 parameters for ``spec`` ((name, shape, init) triples): one
    draw of normal·0.02 values from a generator on ``device``, cut into the
    leaves, and LayerNorm scales of one and biases of zero."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, what))
    normal = [(n, s) for n, s, init in spec if init == "normal"]
    total = sum(int(torch.Size(s).numel()) for _, s in normal)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32).mul_(0.02)
    out, at = {}, 0
    for name, shape in normal:
        size = int(torch.Size(shape).numel())
        out[name] = flat[at : at + size].view(shape)
        at += size
    for name, shape, init in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Named host-clock spans around the program's calls. When ``timed``,
    each span synchronises the device at its ends (the traced run's
    per-layer times); otherwise the wrapper only passes through. Either
    way ``on_result`` sees each call's result."""

    def __init__(self, device, timed: bool):
        self.device, self.timed = device, timed
        self.ms: dict[str, list[float]] = {}
        self.counts: dict[str, float] = {}

    def wrap(self, obj, method: str, name: str | None, on_result=None) -> None:
        """Wrap ``obj.method``: a span ``name`` (None: no span) and
        ``on_result(args, kwargs, result)`` after each call."""
        inner = getattr(obj, method)

        def wrapper(*args, **kwargs):
            if self.timed and name is not None:
                sync(self.device)
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"portbench.{name}"):
                    out = inner(*args, **kwargs)
                sync(self.device)
                self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            else:
                out = inner(*args, **kwargs)
            if on_result is not None:
                on_result(args, kwargs, out)
            return out

        setattr(obj, method, wrapper)

    def count(self, name: str, value: float) -> None:
        self.counts[name] = self.counts.get(name, 0.0) + value


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(count: int) -> dict:
    return dict(
        platform="gpu",
        kind=torch.cuda.get_device_name(0),
        count=count,
        memory_peak_bytes=int(torch.cuda.max_memory_allocated()),
    )


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    at or under its limit (and is a number)."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
