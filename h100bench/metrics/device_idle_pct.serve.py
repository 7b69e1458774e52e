"""The share of the traced window in which no kernel, copy or set ran on the
device, from the profiler's timeline, in %."""
from h100bench.lib.readers import device_idle_pct as read  # noqa: F401
