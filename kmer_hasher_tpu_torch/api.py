"""Public API of the PyTorch port — the reference's R surface
(kmer_hash.R:5-96), as in ``kmer_hasher_tpu.api``.

R name                      -> here
make.kmer.hash(seq,k,sort)  -> make_kmer_hash(seq, k, do_sort=False, device)
kmer.pos(ptr, opt.flag)     -> kmer_pos(index, opt_flag)
seq.kmer.pos(ptr, seq, k)   -> seq_kmer_pos(index, seq, k)
kmer.pairs(a, b)            -> kmer_pairs(a, b)
count.kmers(seq, params)    -> count_kmers(seqs, k, source, source_n, store)
count.kmers.fq(file, ...)   -> count_kmers_fq(file, k, min_q, ...)
count.kmers.fq.sh(file,...) -> count_kmers_fq_sh(file, k, min_q, ...)
count.kmers.fq.sh.rp(...)   -> count_kmers_fq_sh_rp(file, ...)  [flagship]
seq.kmer.depth.sh(ptr,s,k)  -> seq_kmer_depth(store, seq, k)
kmer.spec.kt/sh(ptr, max)   -> kmer_spectrum(store, max_count)
kmer.spec.sh.n(...)         -> kmer_spectrum_n(store, max_count, comb, ...)

Every entry that builds something takes a ``device`` and runs on the card
(``"cuda"``) unless the caller asks for ``"cpu"``; a CUDA device with no
card raises. Tables, query rows, count rows and depth tracks come back as
tensors on that device; spectra are small float64 numpy arrays. Every
name the JAX package's ``api`` exports is exported here, and with them
``init_distributed`` and ``host_read_slice`` for counting and for the
sharded position index over several processes (``parallel.distributed``;
``parallel.ShardedKmerIndex`` on ``parallel.make_mesh(D,
distributed=True)``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .counting import (count_kmers, count_kmers_fq, count_kmers_fq_sh,
                       count_kmers_fq_sh_rp, seq_kmer_depth)
from .index import CountStore, KmerIndex
from .index.query import (iter_kmer_pairs_chunks, iter_seq_kmer_pos_chunks,
                          kmer_pairs, seq_kmer_pos)
from .parallel.distributed import host_read_slice, init_distributed
from .utils.trace import span

__all__ = [
    "KmerIndex",
    "CountStore",
    "make_kmer_hash",
    "make_kmer_hash_many",
    "kmer_pos",
    "seq_kmer_pos",
    "iter_seq_kmer_pos_chunks",
    "kmer_pairs",
    "iter_kmer_pairs_chunks",
    "count_kmers",
    "count_kmers_fq",
    "count_kmers_fq_sh",
    "count_kmers_fq_sh_rp",
    "seq_kmer_depth",
    "kmer_spectrum",
    "kmer_spectrum_n",
    "init_distributed",
    "host_read_slice",
]


def make_kmer_hash(seq, k: int, do_sort: bool = False,
                   device="cuda") -> KmerIndex:
    """Build a k-mer position index (``make.kmer.hash``,
    src/kmer_hash.c:506-540) on ``device``. ``do_sort`` is accepted for
    parity; positions are always sorted here."""
    return KmerIndex(seq, k, do_sort=do_sort, device=device)


def make_kmer_hash_many(seqs, k: int, device="cuda") -> List[KmerIndex]:
    """One index per sequence, in input order (the reference loops
    make.kmer.hash per sequence)."""
    return KmerIndex.build_many(seqs, k, device=device)


def kmer_pos(index: KmerIndex, opt_flag: int,
             max_pairs: Optional[int] = None) -> Dict:
    """Extract kmer/pos/pair.pos/count tables (``kmer.pos``,
    src/kmer_hash.c:1054-1147). Set ``max_pairs`` to guard against pair
    blow-ups, or use ``index.iter_pair_chunks()`` to stream."""
    return index.tables(opt_flag, max_pairs=max_pairs)


def kmer_spectrum(store: CountStore, max_count: int) -> np.ndarray:
    """``kmer.spec.kt`` / ``kmer.spec.sh`` (src/kmer_hash.c:975-1008):
    counts histogram clamped into the last bin; kmer_tree-mode stores
    include the zero cells of allocated prefix blocks."""
    with span("kmh.store.spectrum"):
        return store.spectrum(max_count)


def kmer_spectrum_n(store: CountStore, max_count: int, comb, comb_inner,
                    source_min) -> np.ndarray:
    """``kmer.spec.sh.n`` (src/kmer_hash.c:1010-1038)."""
    return store.spectrum_n(max_count, comb, comb_inner, source_min)
