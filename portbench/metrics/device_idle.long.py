"""% of the window in which no operation ran on the device.

In the long-document cell; moves ``long_answers_per_s``."""

from portbench.harness.readers import device_idle as read  # noqa: F401
