"""Median milliseconds of the queries of the untraced window, each from the
call of ``seq_kmer_pos`` to its hits on the host (host clock)."""

import numpy as np


def read(ctx):
    lat = [j["latency_s"] for j in ctx["jobs"] if "latency_s" in j]
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
