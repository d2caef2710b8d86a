"""The port's CountStore against the JAX package's on the same batches:
every query is an integer table, so equality is exact. The port holds a
k-mer as one raw int64 pattern, the JAX package as (hi, lo) uint32 lanes;
``lanes`` maps between them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.index.count_store import CountStore as JaxStore
from kmer_hasher_tpu_torch.index import count_store as tcs
from kmer_hasher_tpu_torch.index.count_store import CountStore


def lanes(raw_u64):
    return (jnp.asarray((raw_u64 >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(raw_u64.astype(np.uint32)))


def kmer_pool(rng, k, n):
    """n distinct-ish k-mers as unsigned patterns, with the all-G k-mer
    (all ones: the JAX package's dead-row key at k = 32) and all-A."""
    top = (1 << (2 * k)) - 1
    pool = rng.integers(0, top, size=n, dtype=np.uint64, endpoint=True)
    pool[0], pool[1] = top, 0
    return pool


def batches(rng, pool, n_batches, size):
    for _ in range(n_batches):
        # a skewed draw: some k-mers recur often, many once
        idx = np.minimum(rng.geometric(0.02, size=size) - 1, len(pool) - 1)
        idx[:2] = (0, 1)
        yield pool[idx], rng.random(size) < 0.8


def pair(k, counts_n, mode, run_build_size=256, **kw):
    t = CountStore(k, counts_n=counts_n, mode=mode, device="cpu", **kw)
    j = JaxStore(k, counts_n=counts_n, mode=mode, **kw)
    t.run_build_size = j.run_build_size = run_build_size
    return t, j


def fill(t, j, rng, k, n_batches=9, size=200, defer=True):
    pool = kmer_pool(rng, k, 300)
    for b, (raw, valid) in enumerate(batches(rng, pool, n_batches, size)):
        source = b % t.counts_n
        t.add_kmers(torch.from_numpy(raw.view(np.int64)),
                    torch.from_numpy(valid), source=source, defer=defer)
        j.add_kmers(*lanes(raw), jnp.asarray(valid), source=source,
                    defer=defer)
    return pool


def assert_same_answers(t, j, rng, pool, k):
    np.testing.assert_array_equal(t.total_added, j.total_added)
    assert t.n_unique == j.n_unique
    assert t.counts_dict() == j.counts_dict()
    for max_count in (1, 7, 300):
        np.testing.assert_array_equal(t.spectrum(max_count),
                                      j.spectrum(max_count))
    top = (1 << (2 * k)) - 1
    absent = rng.integers(0, top, size=50, dtype=np.uint64, endpoint=True)
    q = np.concatenate([pool[:120], absent])
    got = t.lookup(torch.from_numpy(q.view(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), j.lookup(*lanes(q)))
    assert t.n_alloc_blocks() == j.n_alloc_blocks()


@pytest.mark.parametrize("k", [5, 16, 21, 32])
@pytest.mark.parametrize("mode,counts_n", [("sh", 1), ("khash", 2),
                                           ("sh", 4)])
def test_deferred_adds_match_jax(k, mode, counts_n):
    rng = np.random.default_rng(1000 * k + counts_n)
    t, j = pair(k, counts_n, mode)
    pool = fill(t, j, rng, k)
    assert t.timings["tier_merges"] >= 3  # several tier merges happened
    assert t.peek_n_unique() == j.peek_n_unique()
    assert len(t._runs) > 0  # peeking folded nothing
    assert_same_answers(t, j, rng, pool, k)
    if counts_n > 1:
        comb = list(range(1, 1 << counts_n))[:5]
        inner = [i % 2 for i in range(len(comb))]
        smin = [1, 2, 1, 3][:counts_n]
        np.testing.assert_array_equal(
            t.spectrum_n(9, comb, inner, smin),
            j.spectrum_n(9, comb, inner, smin))


@pytest.mark.parametrize("k,prefix_bits", [(5, 4), (16, 12), (21, 16),
                                           (32, 36)])
def test_ktree_spectra_count_zero_cells(k, prefix_bits):
    rng = np.random.default_rng(k)
    t, j = pair(k, 1, "ktree", prefix_bits=prefix_bits)
    assert (t.prefix_bits, t.suffix_bits) == (j.prefix_bits, j.suffix_bits)
    pool = fill(t, j, rng, k, n_batches=5)
    assert_same_answers(t, j, rng, pool, k)
    assert t.spectrum(5)[0] > 0  # zero cells of the allocated blocks


@pytest.mark.parametrize("k", [5, 32])
def test_eager_adds_and_more_adds_after_a_fold(k):
    rng = np.random.default_rng(k + 77)
    t, j = pair(k, 2, "sh")
    pool = fill(t, j, rng, k, n_batches=3, defer=False)
    assert_same_answers(t, j, rng, pool, k)
    pool2 = fill(t, j, rng, k, n_batches=4)  # on top of the base table
    assert t.peek_n_unique() == j.peek_n_unique()
    assert_same_answers(t, j, rng, np.concatenate([pool, pool2]), k)


@pytest.mark.parametrize("k", [16, 32])
def test_add_run_matches_a_dict_count(k):
    rng = np.random.default_rng(k + 5)
    pool = kmer_pool(rng, k, 200)
    t = CountStore(k, counts_n=2, device="cpu")
    want: dict = {}
    for b, (raw, valid) in enumerate(batches(rng, pool, 7, 300)):
        source = b % 2
        obs = torch.from_numpy(raw.view(np.int64))[torch.from_numpy(valid)]
        keys, cnt = tcs.build_run(obs ^ tcs.enc.SIGN, 2, source)
        assert bool((keys[1:] > keys[:-1]).all())
        t.add_run(keys, cnt, int(valid.sum()), source=source)
        for kk in raw[valid].tolist():
            want.setdefault(kk, [0, 0])[source] += 1
    assert t.counts_dict() == want
    assert int(t.total_added.sum()) == sum(map(sum, want.values()))
    assert list(t.counts_dict()) == sorted(want)  # unsigned k-mer order
    with pytest.raises(ValueError):
        t.add_run(keys, cnt[:, :1], 0)


def sort_form_merge(a, b):
    """The two-run merge as concat + one full sort + neighbour add — what
    the tier merge was before it went through kernel B3."""
    keys, cnt = torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]])
    s, order = torch.sort(keys)
    cnt = cnt[order]
    starts = tcs._segment_starts(s)
    nxt_same = torch.zeros_like(starts)
    nxt_same[:-1] = ~starts[1:]
    absorb = torch.zeros_like(cnt)
    absorb[:-1] = cnt[1:]
    return s[starts], (cnt + absorb * nxt_same[:, None])[starts]


def run_of(rng, pool, n, counts_n):
    keys = np.sort(rng.choice(pool, size=n, replace=False))
    return (torch.from_numpy(keys),
            torch.from_numpy(rng.integers(0, 50, size=(n, counts_n))))


TWO_RUNS = {  # (rows of A, rows of B, how B's keys relate to A's)
    "unequal, half shared": (700, 130, "mixed"),
    "disjoint": (300, 300, "disjoint"),
    "identical keys": (257, 257, "same"),
    "A empty": (0, 40, "mixed"),
    "B empty": (40, 0, "mixed"),
    "both empty": (0, 0, "mixed"),
    "one row each, equal": (1, 1, "same"),
}


@pytest.mark.parametrize("counts_n", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(TWO_RUNS))
def test_two_run_merge_through_b3_equals_the_sort_form(case, counts_n):
    """``merge_runs`` of two runs goes through ``cuda_merge.merge`` (its
    plain version on the CPU): bitwise the concat + sort form, with the
    all-ones key (a real k-mer here) present in both runs."""
    na, nb, relation = TWO_RUNS[case]
    rng = np.random.default_rng(na + 3 * nb + counts_n)
    pool = np.unique(rng.integers(-2 ** 63, 2 ** 63 - 1, size=2000))
    pool[-1] = 2 ** 63 - 1  # sortable form of the all-ones pattern
    a = run_of(rng, pool[1::2] if relation == "disjoint" else pool, na,
               counts_n)
    if relation == "same":
        b = (a[0].clone(), torch.from_numpy(
            rng.integers(0, 50, size=(nb, counts_n))))
    else:
        b = run_of(rng, pool[::2] if relation == "disjoint" else pool, nb,
                   counts_n)
    calls = []
    real = tcs.cuda_merge.merge
    try:
        tcs.cuda_merge.merge = lambda *args: calls.append(1) or real(*args)
        got = tcs.merge_runs((a, b))
    finally:
        tcs.cuda_merge.merge = real
    assert calls == [1]
    want = sort_form_merge(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int64
    assert int(got[1].sum()) == int(a[1].sum()) + int(b[1].sum())
    if relation == "same":
        assert got[0].shape[0] == na
    if relation == "disjoint":
        assert got[0].shape[0] == na + nb


def test_folds_of_two_runs_are_counted_apart_from_tier_merges():
    t = CountStore(21, device="cpu")
    t.run_build_size = 8
    rng = np.random.default_rng(0)
    for size in (40, 9):  # two runs of different classes: no tier merge
        raw = rng.integers(0, 1 << 42, size=size)
        t.add_kmers(torch.from_numpy(raw), torch.ones(size, dtype=torch.bool),
                    defer=True)
    assert len(t._runs) == 2 and t.timings["tier_merges"] == 0
    t.flush()
    assert t.timings["folds"] == 1 and t.timings["fold_merges"] == 1
    assert t.n_unique == 49 and int(t.cnt.sum()) == 49
    assert set(t.timings) == {"tier_merges", "tier_merge_s",
                              "tier_merge_rows", "folds", "fold_merges",
                              "range_rounds",
                              "fold_s", "spills", "spill_s", "spilled_rows",
                              "ranged_folds", "ranges", "rejoin_s",
                              "rejoined_rows", "staging_bytes", "staging_s",
                              "spectrum_n_s", "depth_s", "depth_windows"}
    assert (t.timings["spills"] == t.timings["ranged_folds"]
            == t.timings["range_rounds"] == 0)


def test_lsm_policy_and_empty_store():
    runs = tcs.lsm_compact([4, 4, 8, 2], lambda r: r, lambda a, b: a + b)
    assert sorted(runs) == [2, 16]
    t = CountStore(21, device="cpu")
    assert t.n_unique == 0 and t.peek_n_unique() == 0
    assert t.counts_dict() == {} and t.n_alloc_blocks() == 0
    assert t.spectrum(3).tolist() == [0.0] * 4
    assert t.lookup(torch.zeros(3, dtype=torch.int64)).tolist() == [[0]] * 3
    t.add_kmers(torch.zeros(4, dtype=torch.int64),
                torch.zeros(4, dtype=torch.bool))
    assert t.n_unique == 0 and t.total_added.tolist() == [0]


def test_constructor_checks():
    with pytest.raises(ValueError):
        CountStore(0, device="cpu")
    with pytest.raises(ValueError):
        CountStore(21, mode="tree", device="cpu")
    with pytest.raises(ValueError):
        CountStore(21, prefix_bits=2, suffix_bits=40, device="cpu")
    with pytest.raises(ValueError, match="budget_semantics"):
        CountStore(21, budget_semantics="keep", device="cpu")
    for kw in (dict(mode="sh", max_size_bytes=1 << 20), dict(mode="ktree")):
        with pytest.raises(ValueError, match="requires"):  # as the JAX store
            CountStore(21, budget_semantics="drop", device="cpu", **kw)
        with pytest.raises(ValueError, match="requires"):
            JaxStore(21, budget_semantics="drop", **kw)
    drop = CountStore(21, mode="ktree", max_size_bytes=1 << 20,
                      budget_semantics="drop", device="cpu")
    assert drop.budget_semantics == "drop" and not drop._admit_frozen
    spill = CountStore(21, spill_bytes=1 << 20, spill_dir="spill-here",
                       device="cpu")
    assert (spill.spill_bytes, spill.spill_dir) == (1 << 20, "spill-here")
    assert spill.flush().n_unique == 0  # nothing spilled, no directory made
    t = CountStore(5, device="cpu")
    with pytest.raises(ValueError):
        t.add_kmers(torch.zeros(1, dtype=torch.int64),
                    torch.ones(1, dtype=torch.bool), source=1)
    with pytest.raises(ValueError):
        t.spectrum(0)
    with pytest.raises(ValueError):
        t.spectrum_n(5, [1], [2], [1])


def test_ktree_budget_raises_like_jax():
    rng = np.random.default_rng(3)
    t, j = pair(16, 1, "ktree", prefix_bits=12, max_size_bytes=1 << 22)
    with pytest.raises(MemoryError):
        fill(t, CountStore(16, device="cpu"), rng, 16, defer=False)
    rng = np.random.default_rng(3)
    with pytest.raises(MemoryError):
        fill(CountStore(16, device="cpu"), j, rng, 16, defer=False)


# -- the fold budget as a keyword ---------------------------------------------

def spill_batches(seed, k, n_batches=8, size=1500, pool_size=4000):
    """Seeded k-mers with repeats within and across batches, many more
    distinct ones than a 4 KiB spill budget holds."""
    rng = np.random.default_rng(seed)
    top = (1 << (2 * k)) - 1
    pool = rng.integers(0, top, size=pool_size, dtype=np.uint64,
                        endpoint=True)
    pool[0], pool[1] = top, 0
    for _ in range(n_batches):
        idx = rng.integers(0, pool_size, size=size)
        yield pool[idx], rng.random(size) < 0.9


def feed(stores, seed, k):
    for raw, valid in spill_batches(seed, k):
        for st in stores:
            if isinstance(st, JaxStore):
                st.add_kmers(*lanes(raw), jnp.asarray(valid), defer=True)
            else:
                st.add_kmers(torch.from_numpy(raw.view(np.int64)),
                             torch.from_numpy(valid), defer=True)


FOLD_BUDGET = 4096


@pytest.mark.parametrize("k", [21, 32])
def test_fold_budget_keyword_folds_by_range_bitwise_the_plain_table(
        k, monkeypatch):
    """A CPU store given ``fold_budget_bytes`` spills, folds by key range
    in several ranges, and gives the table and spectrum of the same reads
    with nothing spilled, and of the JAX store whose fold budget is the
    same number by ``KMH_FOLD_BUDGET_BYTES``. The keyword wins over the
    variable."""
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", str(1 << 60))
    t = CountStore(k, spill_bytes=4096, fold_budget_bytes=FOLD_BUDGET,
                   device="cpu")
    plain = CountStore(k, device="cpu")
    j = JaxStore(k, spill_bytes=4096)
    t.run_build_size = plain.run_build_size = j.run_build_size = 1 << 9
    feed((t, plain, j), 5 + k, k)
    assert t.fold_budget_bytes == FOLD_BUDGET
    t.flush(), plain.flush()
    tm = t.timings
    assert tm["spills"] >= 2
    assert tm["ranged_folds"] == 1 and tm["ranges"] >= 2
    # every spilled run (the resident ones spilled at the fold included)
    # went up once, slice by slice
    assert tm["rejoined_rows"] == tm["spilled_rows"] > 0
    assert tm["rejoin_s"] > 0
    assert tm["staging_bytes"] == 0  # a CPU store stages nothing
    assert torch.equal(t.keys, plain.keys) and torch.equal(t.cnt, plain.cnt)
    for max_count in (1, 9, 300):
        np.testing.assert_array_equal(t.spectrum(max_count),
                                      plain.spectrum(max_count))
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", str(FOLD_BUDGET))
    assert j._ranged_fold_needed(0)
    assert t.counts_dict() == j.counts_dict()
    np.testing.assert_array_equal(t.spectrum(300), j.spectrum(300))


def test_fold_budget_keyword_wins_over_a_small_variable(monkeypatch):
    """With the variable tiny and the keyword large, the fold rejoins the
    spilled runs one at a time; ``rejoined_rows`` counts their rows."""
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", str(FOLD_BUDGET))
    t = CountStore(21, spill_bytes=4096, fold_budget_bytes=1 << 40,
                   device="cpu")
    plain = CountStore(21, device="cpu")
    t.run_build_size = plain.run_build_size = 1 << 9
    feed((t, plain), 17, 21)
    spilled = t._spilled_rows
    assert len(t._spilled) >= 2 and not t._ranged_fold_needed(10 ** 6)
    t.flush(), plain.flush()
    tm = t.timings
    assert tm["ranged_folds"] == 0 and tm["ranges"] == 0
    assert tm["rejoined_rows"] == spilled == tm["spilled_rows"]
    assert torch.equal(t.keys, plain.keys) and torch.equal(t.cnt, plain.cnt)


def test_fold_budget_none_reads_the_variable(monkeypatch):
    """Without the keyword the budget is ``_fold_budget_bytes`` as before:
    the variable where it is set, else none to protect on the CPU."""
    t = CountStore(21, spill_bytes=0, device="cpu")
    assert t.fold_budget_bytes is None
    monkeypatch.delenv("KMH_FOLD_BUDGET_BYTES", raising=False)
    assert t._fold_budget() == tcs._fold_budget_bytes(torch.device("cpu"))
    assert not t._ranged_fold_needed(10 ** 12)
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", "800")
    assert t._fold_budget() == 800
    assert t._ranged_fold_needed(11) and not t._ranged_fold_needed(10)
    given = CountStore(21, spill_bytes=0, fold_budget_bytes=1600,
                       device="cpu")
    assert given._fold_budget() == 1600
    assert given._ranged_fold_needed(21) and not given._ranged_fold_needed(20)
