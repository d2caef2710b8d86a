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

The JAX package's merge-sort and bitonic paths compute the same answers
and are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .encode import sortable_key


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
    """
    implicit = pos is None
    if implicit:
        pos = torch.arange(1, key.shape[-1] + 1, dtype=torch.int32,
                           device=key.device)
    pos = pos.to(torch.int32).expand_as(key)
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

