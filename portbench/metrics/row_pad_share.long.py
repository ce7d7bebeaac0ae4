"""% of the slots handed to the extractor's forward that belong to the rows
added to round the row count up to its bucket: the program's counters
``extract.row_pad_slots`` over ``extract.slots``. The rest of
``pad_share`` is each row's padding to the bucketed length.

In the long-document cell; moves ``long_answers_per_s``."""

from portbench.harness.program import counter_share


def read(rec):
    return counter_share("extract.row_pad_slots", "extract.slots")
