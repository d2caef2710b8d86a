"""Plain reference of ``seq.kmer.pos`` (src/kmer_pos.c:101-136) against
the chromosome's index, in plain PyTorch.

For every valid window of the query (:func:`common.windows`), in query
order, and every start of the same k-mer in the indexed sequence in
ascending order, one row (i, j): i the 1-based query position of the
window's last base, j the 1-based start in the indexed sequence.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import common
from .chr21_k32 import sorted_windows


def query_hits(seq: np.ndarray, queries: List[np.ndarray], k: int,
               dev: torch.device, soft_mask_as_n: bool = False
               ) -> List[np.ndarray]:
    """The (i, j) rows of each query, int32 [hits, 2]."""
    key, pos = sorted_windows(seq, k, dev, soft_mask_as_n)
    out = []
    for q in queries:
        s = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
        qk, valid = common.windows(s, k, soft_mask_as_n)
        qk = common.unsigned_order(qk)
        lo = torch.searchsorted(key, qk)
        hi = torch.searchsorted(key, qk, right=True)
        c = torch.where(valid, hi - lo, 0)
        w = torch.repeat_interleave(torch.arange(qk.shape[0], device=dev), c)
        first_of = torch.cumsum(c, 0) - c
        t = torch.arange(w.shape[0], device=dev) - first_of[w]
        rows = torch.stack([w + k, pos[lo[w] + t]], 1)
        out.append(rows.to(torch.int32).cpu().numpy())
    return out
