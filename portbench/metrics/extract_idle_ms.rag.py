"""ms a call in which the device ran nothing while the host was inside
the extractor's spans (``vrag.extract.*``: plan, pad, forward, decode):
the window's idle intervals intersected with the union of those spans
(``harness/program.py``).

In the burst cell; moves ``answers_per_s``."""

from portbench.harness.program import idle_inside_ms


def read(rec):
    return idle_inside_ms(rec, "extract.")
