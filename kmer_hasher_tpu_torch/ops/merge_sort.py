"""Hierarchical merge sort of (key, payload) pairs (PyTorch port of
``kmer_hasher_tpu/ops/merge_sort.py``), the path behind ``KMH_MERGE_SORT=1``
in :func:`ops.sort.sort_windows`.

  phase 1   reshape [N] -> [R, Lt] and sort every row lexicographically
            with ``torch.sort`` (the JAX package leaves this phase to
            ``lax.sort`` too: it is not one of its Pallas kernels);
  phase 2   log2(R) rounds; a round merges adjacent run pairs [A|B] into
            one sorted run of twice the length — one launch of kernel B3
            (``ops/cuda_merge.py``) per round, all pairs in it.

Comparator: lexicographic (key, payload), the key a sortable int64
(``ops.encode.sortable_key``: signed order is k-mer order), the payload 32
bits compared **unsigned**, held in an int32 tensor (the k = 32 index
payload sets bit 31 for invalid windows). The result equals a stable sort
by key with payload-ascending ties.

``Lt`` is 2^15, as in the JAX package: at 2^26 elements that is 2^11 runs
and 11 merge rounds. :func:`merge_path_splits` is kept as a plain function
of the same contract as the JAX one; B3 does this search inside the kernel.
Not ported: ``_merge_round_bitonic`` and ``bitonic_merge_rows``, the JAX
package's XLA fallback rounds, shaped for the TPU and equal in output.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_merge

LT = 1 << 15  # phase-1 row length, read when a sort is called


def unsigned_pay(pay: torch.Tensor) -> torch.Tensor:
    """An int32 payload lane as int64 values in [0, 2^32)."""
    return pay.to(torch.int64) & 0xFFFFFFFF


def lex_sort(key: torch.Tensor, pay: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (key, payload) lexicographically along the last axis: a stable
    LSD pair of ``torch.sort`` passes, payload first, then key."""
    by_pay = torch.sort(unsigned_pay(pay), dim=-1, stable=True).indices
    s_key, order = torch.sort(key.gather(-1, by_pay), dim=-1, stable=True)
    return s_key, pay.gather(-1, by_pay.gather(-1, order))


def _leq(ak, ap, bk, bp):
    """Lexicographic (key, unsigned payload) <=."""
    return (ak < bk) | ((ak == bk) & (ap <= bp))


def merge_path_splits(a_key: torch.Tensor, a_pay: torch.Tensor,
                      b_key: torch.Tensor, b_pay: torch.Tensor, T: int
                      ) -> torch.Tensor:
    """Exact merge-path boundaries for merging equal-length sorted runs A
    and B: for each output boundary r = t*T (t = 0..2L/T), the count i_t of
    A-elements among the first r merged elements, so that A[:i_t] and
    B[:r - i_t] are exactly the first r of the merge. Binary search on i
    with the predicate A[i] <= B[r-i-1], all boundaries at once."""
    L = int(a_key.shape[0])
    dev = a_key.device
    ap, bp = unsigned_pay(a_pay), unsigned_pay(b_pay)
    r = torch.arange((2 * L) // T + 1, dtype=torch.int64, device=dev) * T
    lo = (r - L).clamp(min=0)
    hi = r.clamp(max=L)
    for _ in range(max(1, L.bit_length())):
        active = lo < hi
        mid = ((lo + hi) // 2).clamp(max=L - 1)
        bj = (r - mid - 1).clamp(0, L - 1)
        take_a = _leq(a_key[mid], ap[mid], b_key[bj], bp[bj])
        lo = torch.where(active & take_a, mid + 1, lo)
        hi = torch.where(active & ~take_a, mid, hi)
    return lo


def sort_kmers_merge(key: torch.Tensor, pay: torch.Tensor,
                     Lt: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort flat (int64 key, int32 payload) lexicographically, the payload
    as unsigned. N must be a power of two and at least 2*Lt to take the
    merge path (the JAX package's own condition); otherwise the ordinary
    sort (:func:`lex_sort`) gives the same answer."""
    Lt = LT if Lt is None else Lt
    n = int(key.shape[0])
    if n < 2 * Lt or n % Lt or (n & (n - 1)):
        return lex_sort(key, pay)
    k, p = lex_sort(key.reshape(n // Lt, Lt), pay.reshape(n // Lt, Lt))
    k, p = k.reshape(-1), p.reshape(-1)
    L = Lt
    while L < n:
        k, p = cuda_merge.merge(k, p, np.arange(0, n + 1, L, dtype=np.int64))
        L *= 2
    return k, p
