"""Per cent of the counting jobs' host seconds, in the untraced window,
spent moving runs off the device (``store.timings["spill_s"]``, a program
counter: the host seconds inside ``kmh.store.spill``, whose copies to the
host wait for their chunks to land)."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if "spill_s" in j.get("timings", {})]
    wall = sum(j["wall_s"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 100.0 * sum(j["timings"]["spill_s"] for j in jobs) / wall
