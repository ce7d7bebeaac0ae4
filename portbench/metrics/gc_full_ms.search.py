"""ms a batch of the interpreter's generation-2 collections in the window
(``gc.callbacks``)."""


def read(rec):
    return rec["gc_full_ms"] / rec["calls"] if "candidate_flops_per_batch" in rec else None
