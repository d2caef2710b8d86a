"""Per cent of the traced window in which the card was idle while
``kmh.count.batch`` was the innermost program span: one batch's Python
and launches from the fused pipeline through ``store.add_run`` and the
run length's readback, outside the tier merges it starts
(``port_bench/spans.py``)."""

from port_bench.spans import window_share


def read(ctx):
    return window_share(ctx, "idle_s", lambda n: n == "kmh.count.batch")
