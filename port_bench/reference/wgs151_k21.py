"""Plain reference of ``count.kmers.fq.sh.rp`` for the read-counting
configuration: the quality-likelihood filter in float64, canonical k-mers,
their counts and the count spectrum, in plain PyTorch on any device and in
blocks of reads so that it fits beside nothing else.

The filter walks each read as the C reference's iterator does
(src/kmer_util.c:95-161), with its two quirks: a window that completes in
the building mode leaves ``acc - ll(newest) + ll(next base)`` as the
constant against which every later base of the rolling mode is judged
(``emitC + ll(base) >= min_ll`` keeps rolling, anything less restarts
after that base), and the building mode adds a base while the running sum
stays strictly above ``min_ll``, restarts at a base whose own ll is above
it, and resets otherwise. ``min_ll`` is the table's entry for ``min_q``.
A window is emitted where the iterator completes or keeps rolling; its
k-mer is the k bases ending there.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import common

BLOCK_READS = 1 << 18


def emit_mask(seq: torch.Tensor, qual: torch.Tensor, lengths: torch.Tensor,
              k: int, min_ll: float, table: torch.Tensor) -> torch.Tensor:
    """bool [B, L]: the window ending at column p is emitted."""
    B, L = seq.shape
    dev = seq.device
    ll = table[qual.long()]
    lengths = lengths.to(torch.int64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    rolling = torch.zeros(B, dtype=torch.bool, device=dev)
    j = torch.zeros(B, dtype=torch.int64, device=dev)
    acc = torch.zeros(B, dtype=torch.float64, device=dev)
    emit_c = torch.zeros(B, dtype=torch.float64, device=dev)
    out = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for p in range(L):
        on = (lengths > k) & (p < lengths)
        cur = ll[:, p]
        nxt = ll[:, p + 1] if p + 1 < L else zero.expand(B)
        nxt = torch.where(p + 1 < lengths, nxt, zero)
        # rolling mode
        v = emit_c + cur
        r_ok = rolling & (v >= min_ll)
        r_fail = rolling & (v < min_ll)
        # building mode
        bv = acc + cur
        add = ~rolling & (bv > min_ll)
        restart = ~rolling & ~add & (cur > min_ll)
        j_b = torch.where(add, j + 1, torch.where(restart, 1, 0))
        acc_b = torch.where(add, bv, torch.where(restart, cur, zero))
        done = ~rolling & (add | restart) & (j_b == k)
        out[:, p] = on & (done | r_ok)
        new_rolling = (rolling & ~r_fail) | done
        new_j = torch.where(rolling, torch.where(r_fail, 0, j), j_b)
        new_acc = torch.where(rolling, torch.where(r_fail, zero, acc), acc_b)
        new_c = torch.where(done, acc_b - cur + nxt,
                            torch.where(r_fail, zero, emit_c))
        rolling = torch.where(on, new_rolling, rolling)
        j = torch.where(on, new_j, j)
        acc = torch.where(on, new_acc, acc)
        emit_c = torch.where(on, new_c, emit_c)
    return out


def window_keys(seq: torch.Tensor, k: int, canonical: bool = True
                ) -> torch.Tensor:
    """int64 [B, L - k + 1]: the k-mer starting at each column as an
    unsigned-ordered key; with ``canonical`` the smaller of the k-mer and
    its reverse complement."""
    c = common.codes(seq)
    fwd = common.unsigned_order(common.forward_keys(c, k))
    if not canonical:
        return fwd
    rc = common.unsigned_order(common.revcomp_keys(c, k))
    return torch.minimum(fwd, rc)


def count_table(batches: List[tuple], cfg: dict, dev: torch.device,
                canonical: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(k-mers as sorted unsigned 2k-bit numbers, their counts) over host
    (seq, qual, lengths, has_qual) batches. Every read here has qualities,
    as the configuration's reads do."""
    k = int(cfg["k"])
    table = torch.tensor(common.q_to_ll(), dtype=torch.float64, device=dev)
    min_ll = float(common.q_to_ll()[33 + int(cfg["min_q"])])
    seq = np.concatenate([b[0] for b in batches])
    qual = np.concatenate([b[1] for b in batches])
    lengths = np.concatenate([b[2] for b in batches])
    if not np.concatenate([b[3] for b in batches]).all():
        raise ValueError("the reference takes reads with qualities only")
    found = []
    for a in range(0, seq.shape[0], BLOCK_READS):
        s = torch.from_numpy(seq[a: a + BLOCK_READS]).to(dev)
        q = torch.from_numpy(qual[a: a + BLOCK_READS]).to(dev)
        n = torch.from_numpy(lengths[a: a + BLOCK_READS]).to(dev)
        emit = emit_mask(s, q, n, k, min_ll, table)[:, k - 1:]
        found.append(window_keys(s, k, canonical)[emit])
        del s, q, n, emit
    keys, counts = torch.unique(torch.cat(found), sorted=True,
                                return_counts=True)
    raw = common.unsigned_order(keys).cpu().numpy().view(np.uint64)
    return raw, counts.cpu().numpy().astype(np.int64)


def spectrum(counts: np.ndarray, max_count: int) -> np.ndarray:
    """Histogram of the counts, counts above ``max_count`` in the last
    bin, as float64 [max_count + 1] (kmer.spec.sh)."""
    return np.bincount(np.minimum(counts, max_count),
                       minlength=max_count + 1).astype(np.float64)
