"""The per-layer readers that more than one metric uses (a metric of the
burst cell and its twin of the long-document cell, which move different
end-to-end metrics). Each takes the traced run's record and returns the
metric, or None where the record holds nothing to read."""

from __future__ import annotations

from portbench.harness.roofline import PEAK_BF16_FLOPS, flash_bound


def span_ms(rec, name: str, rag_only: bool = False):
    """ms a call spent in the harness's synchronised span ``name``."""
    ms = rec["spans"].get(name)
    if not ms or (rag_only and "model_flops" not in rec):
        return None
    return sum(ms) / rec["calls"]


def pad_share(rec):
    """% of the slots handed to the extractor's forward that are padding."""
    slots = rec["counts"].get("slots")
    return 100.0 * rec["counts"]["pad_slots"] / slots if slots else None


def flash_fwd_roofline(rec):
    """% of the flash forward's least time its kernels took: the bound of
    each launch's shapes, live lengths and band, summed, over the device
    seconds of the kernels named ``flash_fwd``."""
    device_s = rec["tracer"].seconds_of(rec["ops"], "flash_fwd")
    if not rec["flash"] or device_s <= 0:
        return None
    lengths = {}
    bound_ms = 0.0
    for (batch, seq, heads, head_dim), lens, window in rec["flash"]:
        key = id(lens)
        if key not in lengths:
            lengths[key] = lens.cpu().tolist()
        bound_ms += flash_bound(batch, seq, heads, head_dim, lengths[key], window)
    return 100.0 * bound_ms / 1e3 / device_s


def model_mfu(rec):
    """% of the bf16 peak (989 TFLOP/s) the window's model FLOPs make: the
    extractor's and providers' matmul parameters and attention pairs over
    live tokens only, counted from the configuration."""
    flops = rec.get("model_flops")
    return 100.0 * flops / (rec["window_s"] * PEAK_BF16_FLOPS) if flops else None


def device_idle(rec):
    """% of the window in which no operation ran on the device (the union
    of the trace's kernel, copy and set intervals)."""
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
