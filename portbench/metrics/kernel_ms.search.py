"""ms of device time a batch: the union of the trace's operation intervals
over the batches of the window."""


def read(rec):
    return 1e3 * rec["busy_s"] / rec["calls"] if rec["busy_s"] > 0 else None
