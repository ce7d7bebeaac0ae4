"""ms a call spends in ``DeviceVectorStore.query_batch`` (synchronised span).

In the burst cell; moves ``answers_per_s``."""

from portbench.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "retrieve", rag_only=True)
