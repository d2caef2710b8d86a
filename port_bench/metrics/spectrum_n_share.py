"""Per cent of the trio jobs' host seconds, in the untraced window, spent
in the combination spectra (``store.timings["spectrum_n_s"]``, a program
counter: the host seconds inside ``kmh.store.spectrum_n``, whose bincounts
end in readbacks, so its seconds include its device time). None where the
program has no such counter."""


def read(ctx):
    jobs = [j for j in ctx["jobs"]
            if "spectrum_n_s" in j.get("timings", {})]
    wall = sum(j["wall_s"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 100.0 * sum(j["timings"]["spectrum_n_s"] for j in jobs) / wall
