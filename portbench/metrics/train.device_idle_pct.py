"""train.device_idle_pct: the device's idle share of the timed window, its
busy time an iteration from the traced device stretch (``harness.device_idle_pct``)."""

from portbench.harness import device_idle_pct as read  # noqa: F401
