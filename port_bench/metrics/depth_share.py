"""Per cent of the trio jobs' host seconds, in the untraced window, spent
in the depth tracks (``store.timings["depth_s"]``, a program counter: the
host seconds inside ``kmh.count.depth``; the tracks' copies to the host
come after the span, so the device work it enqueues may end outside it).
None where the program has no such counter."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if "depth_s" in j.get("timings", {})]
    wall = sum(j["wall_s"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 100.0 * sum(j["timings"]["depth_s"] for j in jobs) / wall
