"""Plain reference of the trio configuration: a three-source count table,
its combination spectra and the child's depth tracks, in plain PyTorch and
NumPy on any device. Nothing here imports the program.

- The table: each source's reads are counted apart by ``wgs151_k21``'s
  :func:`count_table` (the float64 quality-likelihood filter, canonical
  k-mers), and the three tables are joined by key into ``[n, 3]`` rows,
  zero where a source lacks the k-mer. Spilling and the ranged fold are
  the program's; the reference holds every table whole.
- The spectra: ``kmer.spec.sh.n`` (src/kmer_hash.c:1010-1038,
  ``sh_count_spectrum_nc`` src/suffix_hash.c:335-425) by masks and
  ``bincount``: a k-mer's flag has bit ``s`` where its source-``s`` count is
  at least ``source_min[s]``; the k-mers a combination selects (flag equal
  to it with ``comb_inner`` 1, sharing a bit with it with 0) add, in row
  ``comb_index * n_sources + s``, one to the bin of their source-``s``
  count, counts above ``max_count`` in the last bin. The C walks the hash
  k-mer by k-mer; the histogram is the same.
- The depth: ``seq.kmer.depth.sh`` in the port's ``"intent"`` semantics,
  which departs from the C deliberately: column ``p`` holds the counts of
  the canonical k-mer starting at ``p`` (the C writes them one column
  earlier), and a window that holds an N or runs past the end is NA
  (INT_MIN), where the C writes counts of the stale register across N gaps
  after an exactly-k region and a partial k-mer at the end. Each window's
  counts are a ``searchsorted`` lookup in the sorted joined table.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import common
from .wgs151_k21 import count_table as source_table
from .wgs151_k21 import window_keys

NA = -(2 ** 31)  # INT_MIN, R's NA_integer_


def _sortable(raw: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Unsigned 2k-bit numbers (uint64) -> int64 of the same order."""
    return common.unsigned_order(torch.from_numpy(raw.view(np.int64)).to(dev))


def count_table(sources: List[list], cfg: dict, dev: torch.device
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(k-mers as sorted unsigned 2k-bit numbers, int64 [n, S] counts):
    source ``s``'s reads counted in column ``s``."""
    tables = [source_table(batches, cfg, dev) for batches in sources]
    keys = torch.cat([_sortable(t[0], dev) for t in tables])
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    cnt = torch.zeros((uniq.shape[0], len(tables)), dtype=torch.int64,
                      device=dev)
    at = 0
    for s, (raw, c) in enumerate(tables):
        cnt[inv[at: at + raw.shape[0]], s] = torch.from_numpy(c).to(dev)
        at += raw.shape[0]
    raw = common.unsigned_order(uniq).cpu().numpy().view(np.uint64)
    return raw, cnt.cpu().numpy()


def spectrum_n(cnt: np.ndarray, max_count: int, comb: Sequence[int],
               comb_inner: Sequence[int], source_min: Sequence[int]
               ) -> np.ndarray:
    """float64 [len(comb) * S, max_count + 1]: the combination spectra of
    the module docstring."""
    S = cnt.shape[1]
    solid = cnt >= np.asarray(source_min, np.int64)[None, :]
    flags = (solid * (1 << np.arange(S))[None, :]).sum(axis=1)
    out = np.zeros((len(comb) * S, max_count + 1), np.float64)
    for j, (cb, inner) in enumerate(zip(comb, comb_inner)):
        sel = flags == cb if inner == 1 else (flags & cb) != 0
        for s in range(S):
            out[j * S + s] = np.bincount(np.minimum(cnt[sel, s], max_count),
                                         minlength=max_count + 1)
    return out


def depth(raw: np.ndarray, cnt: np.ndarray, seq: np.ndarray, k: int,
          dev: torch.device) -> np.ndarray:
    """int32 [S, len(seq)]: the depth tracks of the module docstring for
    host ASCII bytes ``seq`` against the joined table (``raw`` sorted)."""
    n, S = seq.shape[0], cnt.shape[1]
    out = np.full((S, n), NA, np.int32)
    if n < k:
        return out
    x = torch.from_numpy(seq).to(dev)
    q = window_keys(x, k)  # sortable canonical keys, one a window start
    flag = common.is_n(x).to(torch.int64)
    before = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    before[1:] = torch.cumsum(flag, 0)
    w = n - k + 1
    clean = before[k: k + w] == before[:w]
    table = _sortable(raw, dev)
    rows = torch.zeros((w, S), dtype=torch.int64, device=dev)
    if table.shape[0]:
        at = torch.searchsorted(table, q).clamp(max=table.shape[0] - 1)
        hit = (table[at] == q) & clean
        rows[hit] = torch.from_numpy(cnt).to(dev)[at[hit]]
    got = torch.where(clean[:, None], rows, NA).to(torch.int32)
    out[:, :w] = got.T.cpu().numpy()
    return out


def sources_summed(cnt: np.ndarray) -> np.ndarray:
    """The three sources counted as one: every count in column 0 (what a
    store fed every read under ``source=0`` holds), the others zero."""
    out = np.zeros_like(cnt)
    out[:, 0] = cnt.sum(axis=1)
    return out
