"""Public API of the PyTorch port — the position-index part of the
reference's R surface (kmer_hash.R:5-96), as in ``kmer_hasher_tpu.api``.

R name                      -> here
make.kmer.hash(seq,k,sort)  -> make_kmer_hash(seq, k, do_sort=False, device)
kmer.pos(ptr, opt.flag)     -> kmer_pos(index, opt_flag)
seq.kmer.pos(ptr, seq, k)   -> seq_kmer_pos(index, seq, k)
kmer.pairs(a, b)            -> kmer_pairs(a, b)

Every build takes an explicit ``device`` ("cpu", "cuda", ...); tables and
query rows come back as tensors on the index's device. A CUDA device
with no card raises.

Still to come, with the counting path: count.kmers / count.kmers.fq /
count.kmers.fq.sh / count.kmers.fq.sh.rp, seq.kmer.depth.sh,
kmer.spec.kt/sh and kmer.spec.sh.n (``count_kmers*``, ``seq_kmer_depth``,
``kmer_spectrum*``, ``CountStore``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .index import KmerIndex
from .index.query import (iter_kmer_pairs_chunks, iter_seq_kmer_pos_chunks,
                          kmer_pairs, seq_kmer_pos)

__all__ = [
    "KmerIndex",
    "make_kmer_hash",
    "make_kmer_hash_many",
    "kmer_pos",
    "seq_kmer_pos",
    "iter_seq_kmer_pos_chunks",
    "kmer_pairs",
    "iter_kmer_pairs_chunks",
]


def make_kmer_hash(seq, k: int, do_sort: bool = False,
                   device="cpu") -> KmerIndex:
    """Build a k-mer position index (``make.kmer.hash``,
    src/kmer_hash.c:506-540) on ``device``. ``do_sort`` is accepted for
    parity; positions are always sorted here."""
    return KmerIndex(seq, k, do_sort=do_sort, device=device)


def make_kmer_hash_many(seqs, k: int, device="cpu") -> List[KmerIndex]:
    """One index per sequence, in input order (the reference loops
    make.kmer.hash per sequence)."""
    return KmerIndex.build_many(seqs, k, device=device)


def kmer_pos(index: KmerIndex, opt_flag: int,
             max_pairs: Optional[int] = None) -> Dict:
    """Extract kmer/pos/pair.pos/count tables (``kmer.pos``,
    src/kmer_hash.c:1054-1147). Set ``max_pairs`` to guard against pair
    blow-ups, or use ``index.iter_pair_chunks()`` to stream."""
    return index.tables(opt_flag, max_pairs=max_pairs)
