"""ms a call the providers spend encoding its questions: the synchronised
spans around ``JaxDenseProvider.embed_batch_device`` and
``JaxSpladeProvider.embed_query_arrays_device``, summed, over the calls.

In the long-document cell; moves ``long_answers_per_s``."""

from portbench.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "encode")
