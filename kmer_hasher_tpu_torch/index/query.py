"""Cross-sequence queries against a KmerIndex (PyTorch port of
``kmer_hasher_tpu/index/query.py``).

``seq_kmer_pos``: the dot-plot query (src/kmer_pos.c:101-136) — stream a
query sequence, and for every query k-mer present in the index emit one
(i, j) row per indexed position: ``i`` is the 1-based position of the
window's LAST base in the query, ``j`` the 1-based start in the indexed
sequence. Rows come in query-stream order with ascending j within a
window — the reference's order.

``kmer_pairs``: the positions cross-product for k-mers shared by two
indexes, in sorted-key order.

Both emit fixed-capacity chunks: a prefix sum of per-window hit counts and
a searchsorted over it map every output row to its source window. Chunk
boundaries may differ from the JAX package's; the concatenated rows do
not. Its compacted expansion plans (``ops/expand.py``) dodge slow TPU
gathers and are not ported.
"""
from __future__ import annotations

from typing import Iterator

import torch

from ..ops import encode as enc
from ..ops import sort as srt
from .position_index import KmerIndex, as_sequence


def _query_ranges(s_key: torch.Tensor, n_valid: int, query_u8: torch.Tensor,
                  k: int, true_len: int):
    """Encode the query and find each window's (lb, count) in the index,
    with the int64 prefix sum of the counts."""
    key, valid = enc.encode_stream(query_u8, k, true_len,
                                   drop_trailing_exact_k=True)
    lb, ub = srt.lookup_bounds(s_key, n_valid, enc.sortable_key(key))
    c = torch.where(valid, ub - lb, 0)
    return lb, c, torch.cumsum(c, dim=0)


def _hit_chunk(s_pos, lb, c, cum_c, k: int, start: int, n: int
               ) -> torch.Tensor:
    """Hit rows [n, 2] = (i, j) for global hit indices [start, start+n)."""
    g = start + torch.arange(n, dtype=torch.int64, device=s_pos.device)
    w = srt.expand_rank_i64(cum_c, g, cum_c.shape[0])
    t = g - (cum_c[w] - c[w])
    i_col = (w + k).to(torch.int32)  # 1-based query position of the last base
    return torch.stack([i_col, s_pos[lb[w] + t]], dim=1)


def _drain(total: int, capacity: int, chunk) -> Iterator[torch.Tensor]:
    capacity = srt.clamp_chunk_capacity(capacity, total)
    for start in range(0, total, capacity):
        yield chunk(start, min(capacity, total - start))


def iter_seq_kmer_pos_chunks(index: KmerIndex, query, k: int,
                             capacity: int = 1 << 20
                             ) -> Iterator[torch.Tensor]:
    """Stream (i, j) int32 hit rows in chunks on the index's device."""
    query = as_sequence(query, "query")
    if query.shape[-1] <= k or k > 31:
        raise ValueError(
            "the sequence should be longer than k and k should not be longer"
            " than 31")
    true_len = int(query.shape[0])
    lb, c, cum_c = _query_ranges(
        index.s_key, index.n_valid, torch.from_numpy(query).to(index.device),
        k, true_len)
    total = int(cum_c[-1])
    if total == 0:
        yield torch.zeros((0, 2), dtype=torch.int32, device=index.device)
        return
    yield from _drain(total, capacity, lambda start, n: _hit_chunk(
        index.s_pos, lb, c, cum_c, k, start, n))


def seq_kmer_pos(index: KmerIndex, query, k: int) -> torch.Tensor:
    """R entry ``seq.kmer.pos``: the full (i, j) matrix."""
    return torch.cat(list(iter_seq_kmer_pos_chunks(index, query, k)), dim=0)


def _pair_ranges(a: KmerIndex, b: KmerIndex):
    """For each live position of index a (sorted order), the matching
    range in index b, as (lb, count, prefix sum of counts)."""
    lb, ub = srt.lookup_bounds(b.s_key, b.n_valid, a.s_key[: a.n_valid])
    c = ub - lb
    return lb, c, torch.cumsum(c, dim=0)


def _pair_hit_chunk(a_pos, b_pos, lb, c, cum_c, start: int, n: int
                    ) -> torch.Tensor:
    g = start + torch.arange(n, dtype=torch.int64, device=a_pos.device)
    w = srt.expand_rank_i64(cum_c, g, cum_c.shape[0])
    t = g - (cum_c[w] - c[w])
    return torch.stack([a_pos[w], b_pos[lb[w] + t]], dim=1)


def _total(cum_c: torch.Tensor) -> int:
    return int(cum_c[-1]) if cum_c.numel() else 0


def iter_kmer_pairs_chunks(a: KmerIndex, b: KmerIndex,
                           capacity: int = 1 << 20,
                           _ranges=None) -> Iterator[torch.Tensor]:
    """Stream the ``kmer.pairs`` cross-product in chunks of at most
    ``capacity`` rows: the (a, b) position table of two repeat-rich
    indexes is the reference's n*(n-1)/2 blow-up if materialised."""
    lb, c, cum_c = _ranges if _ranges is not None else _pair_ranges(a, b)
    total = _total(cum_c)
    if total == 0:
        yield torch.zeros((0, 2), dtype=torch.int32, device=a.device)
        return
    yield from _drain(total, capacity, lambda start, n: _pair_hit_chunk(
        a.s_pos, b.s_pos, lb, c, cum_c, start, n))


def kmer_pairs(a: KmerIndex, b: KmerIndex, capacity: int = 1 << 20,
               max_pairs: "int | None" = None) -> torch.Tensor:
    """R entry ``kmer.pairs``: (a, b) position cross-product over shared
    k-mers, sorted-key order, ascending positions. ``max_pairs`` guards
    against the blow-up (stream past it with the iterator)."""
    ranges = _pair_ranges(a, b)
    if max_pairs is not None:
        total = _total(ranges[2])
        if total > max_pairs:
            raise MemoryError(
                f"kmer.pairs has {total} rows > max_pairs={max_pairs}; "
                "stream them with iter_kmer_pairs_chunks instead")
    return torch.cat(
        list(iter_kmer_pairs_chunks(a, b, capacity, _ranges=ranges)), dim=0)


def kmer_pairs_total(a: KmerIndex, b: KmerIndex) -> int:
    """Row count of the ``kmer.pairs`` table without materialising it."""
    return _total(_pair_ranges(a, b)[2])
