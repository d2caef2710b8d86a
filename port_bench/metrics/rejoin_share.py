"""Per cent of the counting jobs' host seconds, in the untraced window,
spent bringing spilled runs back in the fold (``store.timings["rejoin_s"]``,
a program counter: the host seconds inside ``kmh.store.rejoin``, the
uploads of every spilled run or key-range slice and their merges, each
merge ending in a readback of its length). None where the program has no
such counter."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if "rejoin_s" in j.get("timings", {})]
    wall = sum(j["wall_s"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 100.0 * sum(j["timings"]["rejoin_s"] for j in jobs) / wall
