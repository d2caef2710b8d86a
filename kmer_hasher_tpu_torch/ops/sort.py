"""Sort-based segmented grouping (PyTorch port of
``kmer_hasher_tpu/ops/sort.py``, index path).

The index is a sorted (k-mer, position) array: grouping, counting and
range queries become a sort, segment boundary flags, prefix sums and
binary search. The sort is ``torch.sort`` (a radix sort on CUDA), as the
JAX package's is an XLA ``lax.sort``.

Keys are the sortable int64 form of the raw patterns (``raw ^ (1 << 63)``,
see ``ops/encode.py``). Invalid windows take the all-ones raw pattern so
they sink to the tail; ``n_valid`` bounds the live prefix. The outputs,
invalid tail included, equal the JAX package's.

``KMH_MERGE_SORT=1``, read at call time as in the JAX package, sends a 1-D
:func:`sort_windows` through the hierarchical merge sort
(``ops/merge_sort.py``: row sorts, then rounds of kernel B3). The JAX
package's other TPU-only merge paths (``bitonic_merge_lanes``,
``lookup_bounds_merge``, ``expand_rank_merge_i64`` and the rest of the
``KMH_MERGE_*`` ladder) compute the same answers and are not ported.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from .encode import SIGN, sortable_key

_I32_MIN = torch.iinfo(torch.int32).min  # bit 31 of a 32-bit lane


def _use_merge_sort() -> bool:
    """Route full 1-D sorts through the hierarchical merge sort
    (``ops.merge_sort``) when ``KMH_MERGE_SORT=1``."""
    return os.environ.get("KMH_MERGE_SORT", "0") == "1"


def _sort_windows_merge(key: torch.Tensor, valid: torch.Tensor, k: int,
                        pos: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sort_windows` as one lexicographic (key, payload) sort through
    ``merge_sort.sort_kmers_merge``, with the JAX package's two payloads:
    the position for k <= 31, and ``(invalid << 31) | position`` for
    k == 32, where a real all-G 32-mer shares the all-ones key with the
    invalid windows (hence the unsigned payload compare). As there, the
    flag is tested before the packed k <= 16 form, so a k <= 16 index takes
    the k <= 31 tail under the flag: ascending positions, raw all-ones.

    An input whose length is no power of two (a shard of the sharded
    index) is padded to one with rows that sort after every other, the
    all-ones key with the all-ones payload, and cut back after the sort:
    the JAX package sorts such a shard at its power-of-two capacity."""
    from . import merge_sort as ms

    pay = pos if k <= 31 else torch.where(valid, pos, pos | _I32_MIN)
    s_key = sortable_key(torch.where(valid, key, -1))
    n = key.shape[0]
    n_pad = 1 << max(0, (n - 1).bit_length())
    if n_pad != n and n_pad >= 2 * ms.LT:
        s_key = torch.cat([s_key, s_key.new_full((n_pad - n,), -1 ^ SIGN)])
        pay = torch.cat([pay, pay.new_full((n_pad - n,), -1)])
    s_key, s_pay = ms.sort_kmers_merge(s_key, pay)
    s_key, s_pay = s_key[:n], s_pay[:n]
    return s_key, s_pay if k <= 31 else s_pay & 0x7FFFFFFF


def sort_windows(key: torch.Tensor, valid: torch.Tensor, k: int,
                 pos: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort windows by (validity, k-mer, position) along the last axis:
    valid entries first, keys ascending, positions ascending within a key
    (the reference's insertion order). Returns (s_key, s_pos): sortable
    keys and int32 1-based window starts.

    ``pos`` gives each window its int32 1-based position (the routed rows
    of a shard of the sharded index carry their global ones); by default
    window i is at i + 1. At k <= 31 the sort is stable on the key, so a
    key's positions come out in input order: ascending where the input is
    in position order, as routed rows are (sender by sender, each in window
    order).

    Three key forms, as in the JAX package, which fix the invalid tail:

    * k <= 16: k-mer and position packed in one word, invalid all-ones —
      the tail reads raw 0xFFFFFFFF, position 0x7FFFFFFF;
    * k <= 31: the k-mer alone, invalid all-ones, stable, so positions
      stay in input order;
    * k == 32: the k-mer fills 64 bits, so a real all-G 32-mer shares the
      all-ones sentinel with invalid windows; a second key (invalid flag,
      then position) breaks the tie. Done as a stable LSD pair: order by
      the second key, then stably by the k-mer.

    With ``KMH_MERGE_SORT=1`` a 1-D input takes
    :func:`_sort_windows_merge` instead; a [B, L] batch ignores the flag.
    """
    implicit = pos is None
    if implicit:
        pos = torch.arange(1, key.shape[-1] + 1, dtype=torch.int32,
                           device=key.device)
    pos = pos.to(torch.int32).expand_as(key)
    if key.dim() == 1 and _use_merge_sort():
        return _sort_windows_merge(key, valid, k, pos)
    if k <= 16:
        packed = torch.where(valid, (key << 32) | pos.to(torch.int64), -1)
        s = sortable_key(torch.sort(sortable_key(packed), dim=-1).values)
        s_key = sortable_key((s >> 32) & 0xFFFFFFFF)
        return s_key, (s & 0x7FFFFFFF).to(torch.int32)
    k1 = sortable_key(torch.where(valid, key, -1))
    if k <= 31:
        s_key, order = torch.sort(k1, dim=-1, stable=True)
        return s_key, pos.gather(-1, order)
    # by default positions ascend with the index, so the invalid flag alone
    # orders the second key
    k2 = (~valid).to(torch.int8) if implicit else (
        pos.to(torch.int64) | torch.where(valid, 0, 1 << 31))
    by_k2 = torch.sort(k2, dim=-1, stable=True).indices
    s_key, order = torch.sort(k1.gather(-1, by_k2), dim=-1, stable=True)
    return s_key, pos.gather(-1, by_k2.gather(-1, order))


def segment_starts(s_key: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """True at the first element of each distinct-key run of the live
    prefix; False in the invalid tail."""
    changed = torch.ones_like(live)
    changed[..., 1:] = s_key[..., 1:] != s_key[..., :-1]
    return changed & live


def segment_ids(starts: torch.Tensor) -> torch.Tensor:
    """0-based segment id per element, int32 (meaningless in the tail)."""
    return torch.cumsum(starts, dim=-1, dtype=torch.int32) - 1


def lookup_bounds(s_key: torch.Tensor, n_valid: int, q_key: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lb, ub) insertion bounds of sortable query keys in the live prefix
    ``s_key[:n_valid]``: the rows of a query's k-mer are s[lb:ub]."""
    live = s_key[:n_valid]
    return (torch.searchsorted(live, q_key),
            torch.searchsorted(live, q_key, right=True))


def searchsorted_i64(sorted_vals: torch.Tensor, q: torch.Tensor,
                     n_valid: int, side: str = "right") -> torch.Tensor:
    """Binary search over the first ``n_valid`` values of a sorted int64
    array (cumulative offset -> source element in chunked expansions)."""
    return torch.searchsorted(sorted_vals[:n_valid], q, side=side)


def expand_rank_i64(sorted_vals: torch.Tensor, g: torch.Tensor,
                    n_valid: int) -> torch.Tensor:
    """searchsorted-right: the source element that owns each output slot
    ``g`` of a chunked expansion over cumulative counts."""
    return searchsorted_i64(sorted_vals, g, n_valid, side="right")


def clamp_chunk_capacity(capacity: int, total: int,
                         floor: int = 1 << 10) -> int:
    """Clamp a drain-chunk capacity to the pow2 ceiling of the known row
    total, so small outputs take small chunks."""
    if total <= floor:
        return min(capacity, floor)
    return min(capacity, 1 << int(total - 1).bit_length())

