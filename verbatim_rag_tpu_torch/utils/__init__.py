"""Shared utilities: profiling and tracing."""

from .profiling import StageTimer, block_and_time, device_trace

__all__ = ["StageTimer", "block_and_time", "device_trace"]
