"""The store's staged copies' share of their roofline, the host link: the
bytes that went through the pinned staging buffers in the traced jobs,
over the device seconds of those copies in the trace, over the link's peak
in one direction.

The seconds are the profiler's own: every ``Memcpy DtoH (Device ->
Pinned)`` that overlaps a ``kmh.store.spill`` span (a run's chunks to the
host) and every ``Memcpy HtoD (Pinned -> Device)`` that overlaps a
``kmh.store.rejoin`` span (the chunks back). The batches' uploads go the
same way as the rejoin's but end before the fold starts. Among the
rejoin's copies are B3's bound uploads, a few bytes and about a microsecond
each, so the share may read a little low. The bytes are the program's
counter ``store.timings["staging_bytes"]`` of the same jobs, which counts
exactly those chunks: the trace gives no copy's size.

Each chunk goes one way at a time, so both directions are held to one
direction's peak. None where the program has no such counter or span, or
the trace no such copy.
"""
import bisect

from port_bench.trace import merge_intervals

# NVIDIA H100 SXM5 data sheet: PCIe Gen5 x16, 128 GB/s both ways together
LINK_BYTES_PER_S = 64e9
COPIES = {"kmh.store.spill": "Memcpy DtoH (Device -> Pinned)",
          "kmh.store.rejoin": "Memcpy HtoD (Pinned -> Device)"}


def copy_s(tr) -> float:
    """Device seconds of the staged copies: each copy of a span's direction
    that overlaps one of its ranges, once."""
    total = 0
    for span, copy in COPIES.items():
        iv = merge_intervals((a, b) for a, b, n in tr.host if n == span)
        starts = [a for a, _b in iv]
        for name, a, b in tr.device:
            if not name.startswith(copy):
                continue
            i = bisect.bisect_left(starts, b) - 1  # the last range from < b
            if i >= 0 and iv[i][1] > a:
                total += b - a
    return total * 1e-9


def read(ctx):
    tr = ctx.get("trace")
    jobs = [j for j in ctx.get("trace_jobs") or []
            if "staging_bytes" in j.get("timings", {})]
    nbytes = sum(j["timings"]["staging_bytes"] for j in jobs)
    if tr is None or not nbytes:
        return None
    secs = copy_s(tr)
    if secs <= 0:
        return None
    return 100.0 * nbytes / secs / LINK_BYTES_PER_S
