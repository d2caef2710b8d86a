"""The quality scan's (kernel B2's) share of its roofline: the bytes the
scan of the traced window's batches needs, over the device time of the kernels
that match ``PATTERNS`` in the trace, over the card's memory bandwidth.

The bytes are the operation's, not an implementation's: per row of a
[rows, width] batch, the bases and qualities read once (2 bytes a column)
and its length (4 bytes), and the outputs written once: the emit flag and
the forward and reverse-complement registers (1 + 8 + 8 bytes a column),
and the read's flag in the pass that flags. Every read goes through the
flagging pass once; a flagged read once more, exactly, without a flag.
"""

PATTERNS = [r"ll_scan_kernel"]


def scan_bytes(rows: int, width: int, flagged: int = 0) -> int:
    """Bytes one pass over ``rows`` reads of ``width`` columns needs with
    the flag, plus the exact pass over the ``flagged`` reads."""
    per_row = 2 * width + 4 + 17 * width
    return rows * (per_row + 1) + flagged * per_row


def read(ctx):
    tr, peak = ctx.get("trace"), ctx.get("peaks", {}).get("hbm_bytes_per_s")
    if tr is None or not peak:
        return None
    jobs = [j for j in ctx.get("trace_jobs") or [] if "width" in j]
    need = sum(scan_bytes(j["reads"], j["width"], j.get("flagged_reads") or 0)
               for j in jobs)
    t = tr.device_s(PATTERNS)
    if not need or t <= 0:
        return None
    return 100.0 * need / t / peak
