"""Per cent of the traced window in which no kernel, copy or fill ran on
the device (the union of the profiler's device activities)."""

from port_bench.trace import idle_share as read  # noqa: F401
