"""% of the window in which no operation ran on the device.

In the burst cell; moves ``answers_per_s``."""

from portbench.harness.readers import device_idle as read  # noqa: F401
