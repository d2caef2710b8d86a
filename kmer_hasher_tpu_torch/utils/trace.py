"""Named host ranges at the port's layer boundaries, for ``torch.profiler``.

``span("kmh.count.batch")`` is a ``torch.profiler.record_function`` range
while a profiler is recording, and otherwise one shared context that does
nothing: with the profiler off a span costs one read of the profiler's flag,
and enters, allocates and synchronises nothing.

The profiler (Kineto) stamps these host ranges and the card's kernels and
copies on one clock, so a trace can put every idle interval of the card
down to the innermost ``kmh.*`` range under way. To see them, run the
program under ``torch.profiler.profile`` and read its events or its Chrome
trace (``export_chrome_trace``); every name starts with ``kmh.``.

Rules for placing a span: only on the thread that launches device work
(a reader that lays every thread's host events on one timeline would take
a producer thread's range for the launching thread's); never open across a
``yield`` (a generator wraps each item's computation, not the loop, so the
consumer's work between items is never inside it); no synchronisation and
no change to any output.
"""
from __future__ import annotations

import contextlib

import torch

_enabled = torch._C._autograd._profiler_enabled
OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else the
    shared no-op :data:`OFF`."""
    if _enabled():
        return torch.profiler.record_function(name)
    return OFF
