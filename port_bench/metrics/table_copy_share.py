"""Per cent of the index jobs' host seconds, in the untraced window, from
the built index (the device synchronised after the build) to its tables,
pair stream and their copies on the host: the benchmark's own span around
``kmer_pos``, ``iter_pair_chunks`` and the copies."""


def read(ctx):
    jobs = [j for j in ctx["jobs"] if "tables_s" in j]
    wall = sum(j["wall_s"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    return 100.0 * sum(j["tables_s"] for j in jobs) / wall
