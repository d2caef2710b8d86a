"""Faults of the ``count`` kind: the store left unchanged by every run,
half of each batch left out, a count altered where the store is flushed."""
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


def count_altered(mp):
    from kmer_hasher_tpu_torch.index.count_store import CountStore

    real = CountStore.flush

    def flush(self):
        out = real(self)
        if self.n_rows:
            self.cnt[0, 0] += 1
        return out

    mp.setattr(CountStore, "flush", flush)


FAULTS = [store_unchanged, half_the_batch, count_altered]
