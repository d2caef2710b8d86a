"""Plain reference of the dot-plot index (``make.kmer.hash`` then
``kmer.pos``, src/kmer_hash.c:506-540, 1054-1147) in plain PyTorch.

Every valid window (:func:`common.windows`) is a (k-mer, 1-based start)
row; the rows sorted by k-mer as an unsigned number, starts ascending
within a k-mer, are the ``pos`` table (i, pos) with i the k-mer's 1-based
rank; ``count`` is each distinct k-mer's rows; ``pair.pos`` holds, k-mer by
k-mer in that order, every (i, x, y) with x before y among its starts,
ordered by x and then y (the reference's nested loop).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import common


def sorted_windows(seq: np.ndarray, k: int, dev: torch.device,
                   soft_mask_as_n: bool = False):
    """(unsigned-ordered keys, 1-based starts) of the valid windows,
    sorted by key and then start."""
    s = torch.from_numpy(np.ascontiguousarray(seq)).to(dev)
    key, valid = common.windows(s, k, soft_mask_as_n)
    start = torch.nonzero(valid).squeeze(1)
    key = common.unsigned_order(key[start])
    key, order = torch.sort(key, stable=True)
    return key, (start[order] + 1)


def index_tables(seq: np.ndarray, k: int, dev: torch.device,
                 soft_mask_as_n: bool = False) -> Dict[str, np.ndarray]:
    key, pos = sorted_windows(seq, k, dev, soft_mask_as_n)
    n = key.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    rank = torch.cumsum(first.to(torch.int64), 0)  # 1-based k-mer rank
    starts = torch.nonzero(first).squeeze(1)
    count = torch.diff(starts, append=torch.tensor([n], device=dev))
    # pairs: row r of a k-mer of c rows, at offset o in it, pairs with the
    # c - 1 - o rows after it
    group_start = starts[rank - 1]
    after = count[rank - 1] - 1 - (torch.arange(n, device=dev) - group_start)
    left = torch.repeat_interleave(torch.arange(n, device=dev), after)
    first_of = torch.cumsum(after, 0) - after
    t = torch.arange(left.shape[0], device=dev) - first_of[left]
    right = left + 1 + t
    pairs = torch.stack([rank[left], pos[left], pos[right]], 1)
    return {"pos": torch.stack([rank, pos], 1).to(torch.int32).cpu().numpy(),
            "count": count.to(torch.int32).cpu().numpy(),
            "pair.pos": pairs.to(torch.int32).cpu().numpy()}
