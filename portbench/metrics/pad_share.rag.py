"""% of the slots of the id and mask arrays handed to the extractor's
forward (``_forward_probs``) that are padding: a count.

In the burst cell; moves ``answers_per_s``."""

from portbench.harness.readers import pad_share as read  # noqa: F401
