"""Per cent of the traced window in which the card was idle while
``kmh.store.spill`` or ``kmh.store.rejoin`` was the innermost program span:
the host moving runs through the pinned staging buffers to and from host
memory, and the rejoin's host work between its merges
(``port_bench/spans.py``)."""

from port_bench.spans import window_share

NAMES = ("kmh.store.spill", "kmh.store.rejoin")


def read(ctx):
    return window_share(ctx, "idle_s", lambda n: n in NAMES)
