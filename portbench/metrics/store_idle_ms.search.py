"""ms a batch in which the device ran nothing while the host was inside
the store's spans (``vrag.store.*``: query preparation, the program's
launches, readback, ``SearchResult`` lists): the window's idle intervals
intersected with the union of those spans (``harness/program.py``).

In the hybrid cell; moves ``search_qps``."""

from portbench.harness.program import idle_inside_ms


def read(rec):
    return idle_inside_ms(rec, "store.")
