"""% of the window in which no operation ran on the device.

In the hybrid cell; moves ``search_qps``."""

from portbench.harness.readers import device_idle as read  # noqa: F401
