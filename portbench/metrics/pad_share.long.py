"""% of the slots of the id and mask arrays handed to the extractor's
forward (``_forward_probs``) that are padding: a count.

In the long-document cell; moves ``long_answers_per_s``."""

from portbench.harness.readers import pad_share as read  # noqa: F401
