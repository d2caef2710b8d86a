"""Per cent of the traced counting jobs' host seconds in which a kernel
ran inside a ``kmh.store.tier_merge`` span: the device side of
``tier_merge_share``. Each merge ends in a readback of its length, so its
kernels end inside its span (``port_bench/spans.py``)."""

from port_bench.spans import jobs_share


def read(ctx):
    return jobs_share(ctx, "kernel_s", "kmh.store.tier_merge")
