"""The port's three-source store (``CountStore(counts_n=3)``) against the
plain reference of the trio configuration
(``port_bench/reference/trio_wgs151_k21.py``) on the CPU: a child's, a
mother's and a father's seeded reads (``port_bench/gen_trio.py``) counted
source by source through ``count_batches`` with nothing spilled, with runs
spilled and rejoined one at a time, and with the fold going by key range;
the (key, 3 counts) table, ``kmer_spectrum_n`` over the seven hap-mer
classes and ``seq_kmer_depth`` along the child's two haplotypes. Then the
share against the whole: column ``s`` of the three-source store is a
one-source count of source ``s``'s reads alone."""
import numpy as np
import pytest
import torch

from kmer_hasher_tpu_torch import api, counting
from kmer_hasher_tpu_torch.ops import encode as enc

CPU = torch.device("cpu")
K = 21
SOURCES = 3
COMB = list(range(1, 1 << SOURCES))
MAX_COUNT = 40
SOURCE_MIN = [2, 2, 2]
# 12x a person on 6 kb, a het rate high enough for some hap-mers a haplotype
CFG = {"k": K, "min_q": 20, "genome_len": 6_000, "read_len": 151,
       "batches": 2, "batch_rows": 240, "col_multiple": 8, "sub_rate": 0.005,
       "qual_bins": "F:,#", "qual_shares": [0.88, 0.08, 0.02, 0.02],
       "het_rate": 0.004, "crossovers": 1}
# store keywords: nothing spilled; every run spilled, rejoined one at a
# time; every run spilled, folded by key range
MODES = {"resident": {},
         "rejoin": {"spill_bytes": 40_000, "fold_budget_bytes": 1 << 40},
         "ranged": {"spill_bytes": 40_000, "fold_budget_bytes": 300_000}}


def reference():
    from port_bench.reference import trio_wgs151_k21

    return trio_wgs151_k21


@pytest.fixture(scope="module")
def trio():
    from port_bench import gen_trio

    return gen_trio.trio(CFG, 2_147_483_801, CPU)


def count(batches_by_source, sources, **store_kw) -> api.CountStore:
    store = api.CountStore(K, counts_n=len(sources), mode="sh", device=CPU,
                           **store_kw)
    for col, batches in zip(sources, batches_by_source):
        counting.count_batches(store, batches, K, min_q=20, source=col,
                               exact_ll="hybrid")
    return store


@pytest.fixture(scope="module")
def stores(trio):
    sources, _child = trio
    return {m: count(sources, range(SOURCES), **kw)
            for m, kw in MODES.items()}


@pytest.fixture(scope="module")
def want(trio):
    sources, child = trio
    ref = reference()
    raw, cnt = ref.count_table(sources, CFG, CPU)
    return {"raw": raw, "cnt": cnt,
            "spectrum_n": ref.spectrum_n(cnt, MAX_COUNT, COMB,
                                         [1] * len(COMB), SOURCE_MIN),
            "depth": [ref.depth(raw, cnt, h, K, CPU) for h in child]}


def test_the_modes_spill_and_fold_as_named(stores):
    tm = {m: s.timings for m, s in stores.items()}
    assert tm["resident"]["spills"] == 0
    assert tm["rejoin"]["spills"] > 0 and tm["rejoin"]["ranged_folds"] == 0
    assert tm["ranged"]["ranged_folds"] == SOURCES  # a fold a source
    assert tm["ranged"]["ranges"] > SOURCES


@pytest.mark.parametrize("what", ["table", "spectrum_n", "depth"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_three_source_store_against_the_reference(stores, trio, want, mode,
                                                  what):
    store = stores[mode]
    if what == "table":
        raw = enc.sortable_key(store.keys).numpy().view(np.uint64)
        assert np.array_equal(raw, want["raw"])
        assert np.array_equal(store.cnt.numpy(), want["cnt"])
        # every column holds k-mers the others lack
        only = (want["cnt"] > 0).sum(axis=1) == 1
        for s in range(SOURCES):
            assert (only & (want["cnt"][:, s] > 0)).any()
    elif what == "spectrum_n":
        got = api.kmer_spectrum_n(store, MAX_COUNT, COMB, [1] * len(COMB),
                                  SOURCE_MIN)
        assert np.array_equal(got, want["spectrum_n"])
        # each of the seven hap-mer classes holds solid k-mers
        assert (want["spectrum_n"].reshape(len(COMB), SOURCES, -1)
                .sum(axis=(1, 2)) > 0).all()
    else:
        _sources, child = trio
        for h, w in zip(child, want["depth"]):
            got = api.seq_kmer_depth(store, h, K)
            assert got.dtype == torch.int32 and got.shape == (SOURCES,
                                                             h.shape[0])
            assert np.array_equal(got.numpy(), w)
            assert (w[1:, : h.shape[0] - K + 1] > 0).any(axis=1).all()


@pytest.mark.parametrize("source", range(SOURCES))
def test_a_column_is_the_one_source_count_of_its_reads(trio, stores,
                                                       source):
    """Column ``s`` of the three-source store, rows where it is nought
    dropped, is the table of a one-source store fed source ``s``'s reads
    alone; the store's ``total_added`` is the one-source stores'."""
    sources, _child = trio
    three = stores["ranged"]
    alone = count([sources[source]], [0], **MODES["ranged"])
    col = three.cnt[:, source]
    assert torch.equal(three.keys[col > 0], alone.keys)
    assert torch.equal(col[col > 0], alone.cnt[:, 0])
    assert three.total_added[source] == alone.total_added[0]
    assert api.kmer_spectrum(alone, MAX_COUNT)[1:].sum() == int(
        (col > 0).sum())


def test_spectrum_n_and_depth_are_spans_with_counters(stores, trio):
    """Under ``torch.profiler`` ``spectrum_n`` and ``seq_kmer_depth`` open
    ``kmh.store.spectrum_n`` and ``kmh.count.depth``, and give what they
    give with the profiler off; either way they add their host seconds
    and the depth's window starts to ``store.timings``."""
    from torch.profiler import ProfilerActivity, profile

    store = stores["resident"]
    _sources, child = trio

    def hapmers():
        return (api.kmer_spectrum_n(store, MAX_COUNT, COMB, [1] * len(COMB),
                                    SOURCE_MIN),
                [api.seq_kmer_depth(store, h, K) for h in child])

    before = dict(store.timings)
    off = hapmers()
    tm = store.timings
    assert tm["spectrum_n_s"] > before["spectrum_n_s"]
    assert tm["depth_s"] > before["depth_s"]
    assert tm["depth_windows"] - before["depth_windows"] == sum(
        h.shape[0] - K + 1 for h in child)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = hapmers()
    names = [e.name for e in prof.events()]
    assert names.count("kmh.store.spectrum_n") == 1
    assert names.count("kmh.count.depth") == len(child)
    assert np.array_equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
