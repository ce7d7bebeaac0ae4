"""% of the flash forward's least time that its kernels took
(``harness/readers.py::flash_fwd_roofline``).

In the burst cell; moves ``answers_per_s``."""

from portbench.harness.readers import flash_fwd_roofline as read  # noqa: F401
