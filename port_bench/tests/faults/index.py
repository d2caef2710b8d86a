"""Faults of the ``index`` kind: no pair chunk streamed, half of the
sequence indexed, a position altered where the pos table is made."""
from __future__ import annotations


def pairs_unchanged(mp):
    from kmer_hasher_tpu_torch.index.position_index import KmerIndex

    mp.setattr(KmerIndex, "iter_pair_chunks", lambda self, *a, **k: iter(()))


def half_the_sequence(mp):
    from kmer_hasher_tpu_torch import api

    real = api.make_kmer_hash
    mp.setattr(api, "make_kmer_hash",
               lambda seq, k, *a, **kw: real(seq[: len(seq) // 2], k, *a,
                                             **kw))


def pos_altered(mp):
    from kmer_hasher_tpu_torch.index.position_index import KmerIndex

    real = KmerIndex.pos_table

    def pos_table(self):
        t = real(self).clone()
        t[-1, 1] += 1
        return t

    mp.setattr(KmerIndex, "pos_table", pos_table)


FAULTS = [pairs_unchanged, half_the_sequence, pos_altered]
