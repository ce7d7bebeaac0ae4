"""ms a call spends in ``ModelSpanExtractor.extract_spans_multi``
(synchronised span).

In the burst cell; moves ``answers_per_s``."""

from portbench.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "extract")
