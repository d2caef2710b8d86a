"""The store merges' (kernel B3's) share of its roofline: the bytes that
merging the traced window's runs needs, over the device time of the
kernels that match ``PATTERNS`` in the trace, over the card's memory
bandwidth.

The element count is the program's own counter ``merge.rows`` of
``ops.cuda_merge`` (every element of every two-run merge: the tier merges
and the fold's). Per element the merge reads its key once (8 bytes) and
writes the merged key (8) and the row it came from (4), which is what the
store's merge asks of it: the count rows follow by a gather outside it.
"""

PATTERNS = [r"merge_path_kernel", r"\bpartition_kernel"]


def merge_bytes(elements: int) -> int:
    """Bytes a merge of ``elements`` keys with a 32-bit row payload
    needs."""
    return elements * (8 + 8 + 4)


def read(ctx):
    tr, peak = ctx.get("trace"), ctx.get("peaks", {}).get("hbm_bytes_per_s")
    if tr is None or not peak:
        return None
    need = sum(merge_bytes(j.get("b3_rows", 0))
               for j in ctx.get("trace_jobs") or [])
    t = tr.device_s(PATTERNS)
    if not need or t <= 0:
        return None
    return 100.0 * need / t / peak
