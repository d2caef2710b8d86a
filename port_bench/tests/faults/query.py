"""Faults of the ``query`` kind: no hits returned, half of each query
looked up, a hit altered where it is produced."""
from __future__ import annotations

import torch


def no_hits(mp):
    from kmer_hasher_tpu_torch import api

    mp.setattr(api, "seq_kmer_pos",
               lambda ix, q, k: torch.zeros((0, 2), dtype=torch.int32))


def half_the_query(mp):
    from kmer_hasher_tpu_torch import api

    real = api.seq_kmer_pos
    mp.setattr(api, "seq_kmer_pos",
               lambda ix, q, k: real(ix, q[: max(len(q) // 2, k + 1)], k))


def hit_altered(mp):
    from kmer_hasher_tpu_torch import api

    real = api.seq_kmer_pos

    def hits(ix, q, k):
        h = real(ix, q, k).clone()
        if h.shape[0]:
            h[h.shape[0] // 2, 1] += 1
        return h

    mp.setattr(api, "seq_kmer_pos", hits)


FAULTS = [no_hits, half_the_query, hit_altered]
