"""% of the rescore's least time that its kernel took: ``rescore_bound``
of each launch's live candidate slots, summed, over the device seconds of
``rescore_kernel``."""

from portbench.harness.roofline import rescore_bound


def read(rec):
    device_s = rec["tracer"].seconds_of(rec["ops"], "rescore_kernel")
    if not rec["rescore"] or device_s <= 0:
        return None
    bound_ms = sum(rescore_bound(cand, ids, w, qm)[0] for cand, ids, w, qm in rec["rescore"])
    return 100.0 * bound_ms / 1e3 / device_s
