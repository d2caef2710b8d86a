"""The k-mer position index (PyTorch port of
``kmer_hasher_tpu/index/position_index.py``).

Build: position-parallel encode (kernel B1 on CUDA) -> sort of (k-mer,
position) -> segment grouping. Tables, counts, dot-plot pairs and queries
are tensor work over the sorted index, on the index's device.

Emission order is sorted-by-(k-mer, position), as in the JAX package;
within a k-mer, positions ascend (the reference's insertion order).
Positions are 1-based. Tables come back as tensors on the index's device
(k-mer strings as a list of str). The n(n-1)/2 pair table streams in
fixed-capacity chunks.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops import encode as enc
from ..ops import sort as srt

MAX_K = 32
_NUC = np.frombuffer(b"ACTG", dtype=np.uint8)  # decode table, kmer_hash.c:21


def as_sequence(seq, what: str = "seq") -> np.ndarray:
    """str / bytes / array-like -> writable 1-D uint8 array (host side)."""
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), dtype=np.uint8).copy()
    seq = np.asarray(seq, dtype=np.uint8)
    if seq.ndim != 1:
        raise ValueError(f"{what} must be a single sequence")
    return seq


def resolve_device(device) -> torch.device:
    """A torch.device; a CUDA device with no card raises (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false")
    return dev


def build_index_arrays(ascii_u8: torch.Tensor, k: int, true_len,
                       drop_trailing_exact_k: bool = True):
    """The build step: encode + sort + group, along the last axis.

    Returns (s_key, s_pos, n_valid, starts, seg_ids) over the full window
    axis; the live prefix has length n_valid. ``s_key`` holds sortable
    keys (``ops.encode.sortable_key``), ``s_pos`` 1-based window starts.
    """
    key, valid = enc.encode_stream(
        ascii_u8, k, true_len, drop_trailing_exact_k=drop_trailing_exact_k)
    s_key, s_pos = srt.sort_windows(key, valid, k)
    n_valid = valid.sum(dim=-1, dtype=torch.int32)
    L = key.shape[-1]
    live = (torch.arange(L, dtype=torch.int32, device=key.device)
            < n_valid.unsqueeze(-1))
    starts = srt.segment_starts(s_key, live)
    return s_key, s_pos, n_valid, starts, srt.segment_ids(starts)


def _group_stats(s_pos: torch.Tensor, n_valid: int, starts: torch.Tensor,
                 seg_ids: torch.Tensor):
    """counts per segment (dense over the window axis), the i column
    (1-based segment rank per element), rank-in-segment, and per-element
    remaining-pair run lengths m_j = count(seg) - 1 - rank, with their
    int64 prefix sum.

    Each element's segment start is read from the start positions by its
    segment id — the JAX package's cummax of start indices, exactly, the
    invalid tail included (torch.cummax over one long axis is a slow
    single-row scan on CUDA)."""
    L = s_pos.shape[-1]
    dev = s_pos.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)
    live = idx < n_valid
    start_idx = torch.nonzero(starts).squeeze(1).to(torch.int32)
    ends = torch.cat([start_idx[1:], torch.tensor([n_valid], dtype=torch.int32,
                                                  device=dev)])
    counts = torch.zeros(L, dtype=torch.int32, device=dev)
    counts[: start_idx.shape[0]] = ends - start_idx
    if start_idx.shape[0]:
        seg_start_idx = start_idx[seg_ids.clamp(min=0).long()]
    else:
        seg_start_idx = torch.full_like(idx, -1)
    rank = idx - seg_start_idx
    i_col = seg_ids + 1
    seg_count = counts[seg_ids.clamp(min=0).long()]
    m = torch.where(live, seg_count - 1 - rank, 0)
    cum_m = torch.cumsum(m, dim=-1, dtype=torch.int64)
    return counts, i_col, rank, m, cum_m


def _pair_chunk(s_pos, i_col, m, cum_m, n_valid: int, start: int, n: int
                ) -> torch.Tensor:
    """Pair rows [n, 3] = (i, x, y) for global pair indices
    [start, start + n), all below the total.

    Row-major within each segment: element j (rank r, segment size c) owns
    the pairs (pos[j], pos[j+1+t]) for t < c-1-r, which concatenated over
    ascending j is the reference's nested j<k loop (src/kmer_hash.c:1113).
    """
    g = start + torch.arange(n, dtype=torch.int64, device=s_pos.device)
    j = srt.expand_rank_i64(cum_m, g, n_valid)
    t = g - (cum_m[j] - m[j])
    return torch.stack([i_col[j], s_pos[j], s_pos[j + 1 + t]], dim=1)


def _unique_compact(s_key: torch.Tensor, starts: torch.Tensor
                    ) -> torch.Tensor:
    """Each segment's key, in segment order (length n_unique)."""
    return s_key[starts]


def _decode_kmers(u_key: torch.Tensor, k: int) -> torch.Tensor:
    """Sortable keys -> [n, k] base indices 0..3 (kmer_hash.c:123-133):
    character j comes from bit offset 2(k-1-j) of the raw pattern."""
    raw = enc.sortable_key(u_key)
    shifts = 2 * (k - 1 - torch.arange(k, device=u_key.device))
    return ((raw.unsqueeze(1) >> shifts) & 3).to(torch.uint8)


class KmerIndex:
    """Position index over a single sequence (``make.kmer.hash``,
    src/kmer_hash.c:506-540), on ``device``.

    Validation matches the reference: 1 <= k <= 32, len(seq) strictly > k.
    ``do_sort`` is accepted for API parity and ignored — positions are
    always emitted sorted. The sequence is padded with N to a power of two
    (at least 64), the JAX package's window axis, so the sorted arrays
    match it element for element.
    """

    def __init__(self, seq, k: int, do_sort: bool = False, device="cuda"):
        if not 1 <= k <= MAX_K:
            raise ValueError("k must be a positive integer less than 1+MAX_K")
        seq = as_sequence(seq)
        if seq.shape[0] <= k:
            raise ValueError("the length of the sequence must be at least k")
        dev = resolve_device(device)
        seq_len = int(seq.shape[0])
        L_pad = 1 << max(6, (seq_len - 1).bit_length())
        # pad on the device: only the sequence itself crosses to it
        x = torch.full((L_pad,), ord("N"), dtype=torch.uint8, device=dev)
        x[:seq_len] = torch.from_numpy(seq)
        s_key, s_pos, n_valid, starts, seg_ids = build_index_arrays(
            x, k, seq_len)
        self._init(k, seq_len, s_key, s_pos, int(n_valid), starts, seg_ids)

    def _init(self, k, seq_len, s_key, s_pos, n_valid, starts, seg_ids):
        self.k = int(k)
        self.seq_len = int(seq_len)
        self.device = s_key.device
        self.s_key, self.s_pos = s_key, s_pos
        self.n_valid = int(n_valid)
        self.starts, self.seg_ids = starts, seg_ids
        (self._counts_dense, self.i_col, self.rank, self.m,
         self.cum_m) = _group_stats(s_pos, self.n_valid, starts, seg_ids)
        self._u_key: Optional[torch.Tensor] = None

    @classmethod
    def from_sorted(cls, k: int, seq_len: int, s_key: torch.Tensor,
                    s_pos: torch.Tensor, n_valid: int) -> "KmerIndex":
        """An index from sorted arrays (a restored checkpoint, or arrays
        built elsewhere): the grouping is recomputed from the keys."""
        ix = cls.__new__(cls)
        live = torch.arange(s_key.shape[0], device=s_key.device) < n_valid
        starts = srt.segment_starts(s_key, live)
        ix._init(k, seq_len, s_key, s_pos, n_valid, starts,
                 srt.segment_ids(starts))
        return ix

    @classmethod
    def build_many(cls, seqs, k: int, device="cuda") -> "List[KmerIndex]":
        """One index per sequence, in input order; every input is checked
        before any is built. The JAX package batches short sequences into
        [B, L] builds as a TPU tuning; its outputs are the same."""
        if not 1 <= k <= MAX_K:
            raise ValueError("k must be a positive integer less than 1+MAX_K")
        arrs = [as_sequence(s, "each seq") for s in seqs]
        if any(a.shape[0] <= k for a in arrs):
            raise ValueError("the length of the sequence must be at least k")
        return [cls(a, k, device=device) for a in arrs]

    # -- derived quantities -------------------------------------------------
    @property
    def s_hi(self) -> torch.Tensor:
        """High 32 bits of the sorted raw patterns (the JAX ``s_hi``)."""
        return enc.split_hi_lo(enc.sortable_key(self.s_key))[0]

    @property
    def s_lo(self) -> torch.Tensor:
        """Low 32 bits of the sorted raw patterns (the JAX ``s_lo``)."""
        return enc.split_hi_lo(enc.sortable_key(self.s_key))[1]

    @property
    def n_kmers(self) -> int:
        """Distinct k-mer count (khash_ptr.kmer_count analogue)."""
        return self.unique_keys()[1]

    def unique_keys(self) -> Tuple[torch.Tensor, int]:
        """(sortable key of each distinct k-mer in order, their number)."""
        if self._u_key is None:
            self._u_key = _unique_compact(self.s_key, self.starts)
        return self._u_key, int(self._u_key.shape[0])

    @property
    def total_pairs(self) -> int:
        if self.n_valid == 0:
            return 0
        return int(self.cum_m[self.n_valid - 1])

    # -- kmer.pos table family (src/kmer_hash.c:1054-1147) ------------------
    def kmer_strings(self) -> List[str]:
        u_key, _ = self.unique_keys()
        chars = _NUC[_decode_kmers(u_key, self.k).cpu().numpy()]
        return [bytes(row).decode("ascii") for row in chars]

    def counts(self) -> torch.Tensor:
        """int32 occurrence count of each distinct k-mer."""
        return self._counts_dense[: self.n_kmers]

    def pos_table(self) -> torch.Tensor:
        """[n_valid, 2] int32 (i, pos): i = 1-based k-mer rank in sorted
        order, pos = 1-based window start."""
        nv = self.n_valid
        return torch.stack([self.i_col[:nv], self.s_pos[:nv]], dim=1)

    def iter_pair_chunks(self, capacity: int = 1 << 20
                         ) -> Iterator[torch.Tensor]:
        """Stream the (i, x, y) pair table in chunks of at most
        ``capacity`` rows — the fix for the reference's pair-table blow-up
        (README.md:80-89)."""
        total = self.total_pairs
        capacity = srt.clamp_chunk_capacity(capacity, total)
        for start in range(0, total, capacity):
            yield _pair_chunk(self.s_pos, self.i_col, self.m, self.cum_m,
                              self.n_valid, start,
                              min(capacity, total - start))

    def pair_table(self, max_pairs: Optional[int] = None) -> torch.Tensor:
        total = self.total_pairs
        if max_pairs is not None and total > max_pairs:
            raise MemoryError(
                f"pair table has {total} rows > max_pairs={max_pairs}; "
                "use iter_pair_chunks() to stream")
        if total == 0:
            return torch.zeros((0, 3), dtype=torch.int32, device=self.device)
        return torch.cat(list(self.iter_pair_chunks()), dim=0)

    def tables(self, opt_flag: int, max_pairs: Optional[int] = None
               ) -> Dict:
        """The ``kmer.pos`` entry (opt_flag bits 1=kmer 2=pos 4=pair.pos
        8=count, src/kmer_hash.c:17)."""
        out = {"kmer": None, "pos": None, "pair.pos": None, "count": None}
        if opt_flag & 1:
            out["kmer"] = self.kmer_strings()
        if opt_flag & 2:
            out["pos"] = self.pos_table()
        if opt_flag & 4:
            out["pair.pos"] = self.pair_table(max_pairs)
        if opt_flag & 8:
            out["count"] = self.counts()
        return out

    # -- queries ------------------------------------------------------------
    def lookup_range(self, q_key: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query (lb, ub) ranges into the sorted position array, for
        raw k-mer patterns as :func:`ops.encode.encode_stream` gives them."""
        return srt.lookup_bounds(self.s_key, self.n_valid,
                                 enc.sortable_key(q_key))
