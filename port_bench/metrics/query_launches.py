"""Kernel launches a query: the host's ``cudaLaunchKernel*`` and
``cuLaunchKernel*`` calls inside ``kmh.query`` spans over the number of
those spans in the traced window (``port_bench/spans.py``)."""

from port_bench.spans import span_table


def read(ctx):
    tr = ctx.get("trace")
    t = span_table(tr) if tr is not None else None
    if not t or not t.get("kmh.query", {}).get("n"):
        return None
    return t["kmh.query"]["launches"] / t["kmh.query"]["n"]
