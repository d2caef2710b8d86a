"""Faults of the ``trio`` kind: the store left unchanged by every run, half
of each batch left out, and the per-source columns broken: every read
counted under source 0, whatever source it was given."""
from __future__ import annotations


def store_unchanged(mp):
    from kmer_hasher_tpu_torch.index.count_store import CountStore

    mp.setattr(CountStore, "add_run", lambda self, *a, **k: self)


def half_the_batch(mp):
    from kmer_hasher_tpu_torch import counting

    real = counting._fused_rp_batch

    def half(seq, qual, lengths, has_qual, *a, **k):
        h = seq.shape[0] // 2
        return real(seq[:h], qual[:h], lengths[:h], has_qual[:h], *a, **k)

    mp.setattr(counting, "_fused_rp_batch", half)


def sources_in_one_column(mp):
    from kmer_hasher_tpu_torch import counting

    real = counting.count_batches

    def one_column(store, batches, k, *a, **kw):
        kw["source"] = 0
        return real(store, batches, k, *a, **kw)

    mp.setattr(counting, "count_batches", one_column)


FAULTS = [store_unchanged, half_the_batch, sources_in_one_column]
