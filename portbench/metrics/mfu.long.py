"""% of the card's bf16 peak that the window's model FLOPs make, over
live tokens only (``harness/readers.py::model_mfu``).

In the long-document cell; moves ``long_answers_per_s``."""

from portbench.harness.readers import model_mfu as read  # noqa: F401
