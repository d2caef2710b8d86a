"""Per cent of the traced window in which the card was idle while
``kmh.count.stage`` was the innermost program span: the host staging the
next batch (its host view, the wait on the pinned slot's event, the copies
into pinned buffers and the enqueue of the upload; ``port_bench/spans.py``)."""

from port_bench.spans import window_share


def read(ctx):
    return window_share(ctx, "idle_s", lambda n: n == "kmh.count.stage")
