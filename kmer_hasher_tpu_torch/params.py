"""Typed parameter objects for the reference's positional int vectors.

The reference passes configuration as positional integer vectors documented
only in comments and inconsistent across entries (kmer_hash.R:49,61,67-74;
SURVEY.md §5 flag system). These dataclasses give each entry a typed config
plus ``from_r_vector`` shims so an R user can migrate a call site verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class CountParams:
    """``count.kmers`` params ``c(k, source, source_n)``
    (src/kmer_hash.c:545-547)."""

    k: int
    source: int = 0
    source_n: int = 1

    @classmethod
    def from_r_vector(cls, v: Sequence[int]) -> "CountParams":
        if len(v) != 3:
            raise ValueError("params must be an integer vector of length 3")
        return cls(k=int(v[0]), source=int(v[1]), source_n=int(v[2]))


@dataclass(frozen=True)
class FqParams:
    """``count.kmers.fq`` / ``.sh`` params
    ``c(k, report_n, prefix_bits, max_mem_gb, min_q, max_read_n)``
    (src/kmer_hash.c:597-616)."""

    k: int
    report_n: int = 1_000_000
    prefix_bits: int = 16
    max_mem_gb: Optional[int] = None
    min_q: int = 0
    max_reads: Optional[int] = None

    @classmethod
    def from_r_vector(cls, v: Sequence[int]) -> "FqParams":
        if len(v) != 6:
            raise ValueError("params must be an integer vector of length 6")
        return cls(
            k=int(v[0]), report_n=int(v[1]), prefix_bits=int(v[2]),
            max_mem_gb=int(v[3]) if v[3] > 0 else None, min_q=int(v[4]),
            max_reads=None if v[5] < 0 else int(v[5]),
        )


@dataclass(frozen=True)
class RpParams:
    """``count.kmers.fq.sh.rp`` params
    ``c(k, prefix_bits, min_q, thread_n, max_reads, max_mem, source_n,
    source)`` (src/kmer_hash.c:813-824)."""

    k: int
    prefix_bits: int = 20
    min_q: int = 20
    n_shards: int = 1
    max_reads: Optional[int] = None
    max_mem_gb: Optional[int] = None
    source_n: int = 1
    source: int = 0

    @classmethod
    def from_r_vector(cls, v: Sequence[int]) -> "RpParams":
        if len(v) != 8:
            raise ValueError(
                "params must be an integer vector of length 8 (k, "
                "prefix_bits, min_q, thread_n, max_reads, max_mem, "
                "source_n, source)"
            )
        return cls(
            k=int(v[0]), prefix_bits=int(v[1]), min_q=int(v[2]),
            n_shards=int(v[3]),
            max_reads=None if v[4] < 0 else int(v[4]),
            max_mem_gb=int(v[5]) if v[5] > 0 else None,
            source_n=int(v[6]), source=int(v[7]),
        )
