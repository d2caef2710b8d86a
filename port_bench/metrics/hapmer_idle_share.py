"""Per cent of the traced window in which the card was idle while
``kmh.store.spectrum_n`` or ``kmh.count.depth`` was the innermost program
span: the host's work between the combination spectra's bincounts and
readbacks, and the depth track's upload, encode and lookup
(``port_bench/spans.py``)."""

from port_bench.spans import window_share

NAMES = ("kmh.store.spectrum_n", "kmh.count.depth")


def read(ctx):
    return window_share(ctx, "idle_s", lambda n: n in NAMES)
