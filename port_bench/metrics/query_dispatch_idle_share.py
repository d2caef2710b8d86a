"""Per cent of the traced window in which the card was idle while
``kmh.query`` or a span under it (``ranges``, ``total``, ``hits``) was the
innermost program span: the query's host work and waits inside
``seq_kmer_pos`` (``port_bench/spans.py``)."""

from port_bench.spans import window_share


def read(ctx):
    return window_share(ctx, "idle_s", lambda n: n == "kmh.query"
                        or n.startswith("kmh.query."))
