"""Per cent of the counting jobs' host seconds, in the untraced window,
spent in the store's tier merges (``store.timings["tier_merge_s"]``, a
program counter; each merge ends in a length readback, so its seconds
include its device time)."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if "tier_merge_s" in j.get("timings", {})]
    wall = sum(j["wall_s"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 100.0 * sum(j["timings"]["tier_merge_s"] for j in jobs) / wall
