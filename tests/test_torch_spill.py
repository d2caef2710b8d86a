"""Host/disk spill and the ranged out-of-core fold of the port's CountStore
against the JAX package's store under the same settings, and against the
port's own eager store: every answer is an integer table, so equality is
exact. Inputs are seeded numpy k-mers handed to both packages (the
counterparts of tests/test_lsm.py's spill and ranged-fold tests)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.index.count_store import CountStore as JaxStore
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch.index import count_store as tcs
from kmer_hasher_tpu_torch.index.count_store import CountStore
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

SIGN = -(2 ** 63)


def lanes(raw_u64):
    return (jnp.asarray((raw_u64 >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(raw_u64.astype(np.uint32)))


def kmer_batches(seed, k, n_batches, size, pool_size=4000):
    """Seeded batches of k-mers (unsigned patterns) with repeats within and
    across batches; the all-G k-mer (all ones: the JAX package's dead-row
    key at k = 32) and all-A are in every batch."""
    rng = np.random.default_rng(seed)
    top = (1 << (2 * k)) - 1
    pool = rng.integers(0, top, size=pool_size, dtype=np.uint64,
                        endpoint=True)
    pool[0], pool[1] = top, 0
    for _ in range(n_batches):
        idx = rng.integers(0, pool_size, size=size)
        idx[:2] = (0, 1)
        yield pool[idx], rng.random(size) < 0.9


def trio(k, counts_n=1, **kw):
    """(port store, JAX store) with the spill settings, and the port's eager
    store without them."""
    t = CountStore(k, counts_n=counts_n, device="cpu", **kw)
    j = JaxStore(k, counts_n=counts_n, **kw)
    t.run_build_size = j.run_build_size = 1 << 9
    return t, j, CountStore(k, counts_n=counts_n, device="cpu")


def drive(t, j, eager, seed, k, n_batches=6, size=1500):
    for b, (raw, valid) in enumerate(kmer_batches(seed, k, n_batches, size)):
        source = b % t.counts_n
        r, v = torch.from_numpy(raw.view(np.int64)), torch.from_numpy(valid)
        t.add_kmers(r, v, source=source, defer=True)
        j.add_kmers(*lanes(raw), jnp.asarray(valid), source=source,
                    defer=True)
        eager.add_kmers(r, v, source=source)


def assert_same(t, j, eager):
    want = eager.counts_dict()
    assert t.counts_dict() == want and j.counts_dict() == want
    for other in (j, eager):
        np.testing.assert_array_equal(t.total_added,
                                      np.asarray(other.total_added))
        np.testing.assert_array_equal(t.spectrum(9), other.spectrum(9))
        assert t.n_alloc_blocks() == other.n_alloc_blocks()
    assert torch.equal(t.keys, eager.keys) and torch.equal(t.cnt, eager.cnt)
    assert bool((t.keys[1:] > t.keys[:-1]).all())  # sorted and unique


@pytest.mark.parametrize("k", [21, 32])
def test_spill_to_host_memory_matches_jax_and_eager(k):
    t, j, eager = trio(k, spill_bytes=4096)
    drive(t, j, eager, 21, k)
    assert t._spilled and j._spilled  # runs really left the device
    assert t._spilled[0][0] == "mem"
    assert t.timings["spills"] == len(t._spilled) + 0
    assert t.timings["spilled_rows"] == t._spilled_rows > 0
    assert t._device_run_bytes() <= 4096
    assert t.peek_n_unique() == eager.n_unique  # folds: the keys are away
    assert_same(t, j, eager)
    assert not t._spilled and t._spilled_rows == 0
    assert t.timings["ranged_folds"] == 0  # one at a time, not by range
    drive(t, j, eager, 99, k, n_batches=1, size=500)  # usable afterwards
    assert_same(t, j, eager)


@pytest.mark.parametrize("k", [21, 32])
def test_spill_to_disk_matches_jax_and_eager(k, tmp_path):
    dirs = [tmp_path / "t", tmp_path / "j"]
    t = CountStore(k, spill_bytes=4096, spill_dir=str(dirs[0]), device="cpu")
    j = JaxStore(k, spill_bytes=4096, spill_dir=str(dirs[1]))
    t.run_build_size = j.run_build_size = 1 << 9
    eager = CountStore(k, device="cpu")
    drive(t, j, eager, 22, k)
    assert t._spilled and t._spilled[0][0] == "file"
    files = list(dirs[0].glob("kmh_spill_*"))
    assert len(files) == len(t._spilled) and files
    assert_same(t, j, eager)
    assert not t._spilled
    assert not list(dirs[0].glob("kmh_spill_*"))  # removed when read back


@pytest.mark.parametrize("k", [21, 32])
def test_ranged_fold_matches_jax_and_eager(k, monkeypatch):
    """With the fold budget forced tiny the rejoin goes by key range in
    both packages: several runs spilled, several ranges merged."""
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", "4096")
    t, j, eager = trio(k, spill_bytes=4096)
    drive(t, j, eager, 31, k, n_batches=10)
    assert len(t._spilled) > 1 and len(j._spilled) > 1
    assert t._ranged_fold_needed(0) and j._ranged_fold_needed(0)
    merges = t.timings["fold_merges"]
    assert_same(t, j, eager)
    tm = t.timings
    assert tm["ranged_folds"] == 1 and tm["ranges"] >= 4
    # every range merged in one pass of B3 rounds, no two-run merge
    assert tm["fold_merges"] == merges and tm["range_rounds"] > 0
    assert not t._spilled and not t._runs
    drive(t, j, eager, 7, k, n_batches=1, size=500)  # and refold on top
    assert_same(t, j, eager)
    assert t.timings["ranged_folds"] == 2  # the base table went out too


def test_ranged_fold_multi_source(monkeypatch):
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", "2048")
    t, j, eager = trio(21, counts_n=3, spill_bytes=4096)
    drive(t, j, eager, 51, 21, n_batches=6, size=1200)
    assert t._spilled and j._spilled
    assert_same(t, j, eager)
    assert t.timings["ranged_folds"] == 1
    assert int((t.cnt > 0).sum(dim=1).max()) > 1  # rows with several sources


def run_of(raw_u64, counts_n=1, source=0):
    """Unsigned patterns (with repeats) -> the port's run and the JAX
    package's run form (pow-2 capacity, dead rows keyed all-ones)."""
    uniq, n = np.unique(raw_u64, return_counts=True)
    keys = torch.from_numpy(uniq.view(np.int64)) ^ SIGN
    cnt = torch.zeros((len(uniq), counts_n), dtype=torch.int64)
    cnt[:, source] = torch.from_numpy(n)
    cap = max(64, 1 << int(len(uniq) - 1).bit_length())
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    jc = np.zeros((cap, counts_n), np.uint32)
    hi[: len(uniq)] = (uniq >> np.uint64(32)).astype(np.uint32)
    lo[: len(uniq)] = uniq.astype(np.uint32)
    jc[: len(uniq), source] = n
    n_obs = np.zeros(counts_n, np.int64)
    n_obs[source] = len(raw_u64)
    return (keys, cnt, len(raw_u64)), (jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.asarray(jc), jnp.asarray(n_obs))


@pytest.mark.parametrize("k", [21, 32])
def test_spill_with_many_small_runs_by_add_run(k, tmp_path):
    """Prebuilt runs (the fused counting path's form) spill to files and
    rejoin exactly."""
    t = CountStore(k, spill_bytes=1 << 12, spill_dir=str(tmp_path / "t"),
                   device="cpu")
    j = JaxStore(k, spill_bytes=1 << 12, spill_dir=str(tmp_path / "j"))
    eager = CountStore(k, device="cpu")
    for raw, valid in kmer_batches(13, k, 8, 200, pool_size=1500):
        tr, jr = run_of(raw[valid])
        t.add_run(*tr)
        j.add_run(*jr)
        eager.add_run(*tr).flush()
    j._flush_deferred()
    assert t._spilled and j._spilled
    assert_same(t, j, eager)
    assert not list((tmp_path / "t").glob("kmh_spill_*"))


def test_ranged_fold_edges(monkeypatch):
    """Few distinct keys (repeated splitters, empty ranges), a run that lies
    wholly inside one range, the all-G 32-mer in several runs, and a flush
    with no resident run at all."""
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", "1024")
    k = 32
    top = np.uint64(2 ** 64 - 1)
    rng = np.random.default_rng(5)
    few = np.array([0, 5, 2 ** 63, top], np.uint64)
    batches = [
        few[rng.integers(0, 4, size=600)],  # four keys only
        rng.integers(0, 2 ** 64 - 1, size=700, dtype=np.uint64),
        np.uint64(7 << 40) + rng.integers(0, 50, size=300, dtype=np.uint64),
        np.concatenate([few, rng.integers(0, 2 ** 64 - 1, size=40,
                                          dtype=np.uint64)]),
    ]
    t = CountStore(k, spill_bytes=1024, device="cpu")
    j = JaxStore(k, spill_bytes=1024)
    eager = CountStore(k, device="cpu")
    for raw in batches:
        tr, jr = run_of(raw)
        t.add_run(*tr)
        j.add_run(*jr)
        eager.add_run(*tr)
    j._flush_deferred()
    assert len(t._spilled) >= 2
    assert_same(t, j, eager)
    assert t.timings["ranged_folds"] == 1 and t.timings["ranges"] >= 2
    assert t.counts_dict()[int(top)][0] > 1  # all-G is a k-mer, not a pad


def overlapping_runs(seed, k, m, pool_size):
    """m runs over one pool of distinct k-mers: run j leaves out every
    (m + 1)-th pool key from phase j, so the runs overlap heavily and every
    few consecutive pool keys hold a key of each run; within a run a key is
    seen once or twice."""
    rng = np.random.default_rng(seed)
    top = (1 << (2 * k)) - 1
    pool = np.unique(rng.integers(0, top, size=pool_size, dtype=np.uint64,
                                  endpoint=True))
    pool[-1] = top  # the all-G k-mer is a key like any other
    x = np.arange(pool.size)
    for j in range(m):
        keys = pool[x % (m + 1) != j]
        yield np.concatenate([keys, keys[rng.random(keys.size) < 0.3]])


# case: (runs, fold budget in rows of a range; 0 = the smallest budget)
RANGE_CASES = {"one slice": (1, 40), "two slices": (2, 40),
               "five slices": (5, 40), "repeated splitters": (3, 0)}


@pytest.mark.parametrize("case", list(RANGE_CASES))
@pytest.mark.parametrize("counts_n", [1, 2])
@pytest.mark.parametrize("k", [21, 32])
def test_range_pass_is_the_unspilled_table(k, counts_n, case, monkeypatch):
    """Every run spilled at once and folded by key range in ranges of a
    known number of slices S, each merged in one pass: ceil(log2 S) B3
    rounds a range, no two-run merge; the table and spectra are bitwise
    those of an unspilled store and of the JAX store folding by range."""
    m, per_range = RANGE_CASES[case]
    row_bytes = 8 + 8 * counts_n
    budget = per_range * tcs.MERGE_PEAK_FACTOR * row_bytes
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", str(max(budget, 1)))
    t = CountStore(k, counts_n=counts_n, spill_bytes=0,
                   fold_budget_bytes=budget, device="cpu")
    j = JaxStore(k, counts_n=counts_n, spill_bytes=0)
    plain = CountStore(k, counts_n=counts_n, device="cpu")
    for r, raw in enumerate(overlapping_runs(k + m, k, m, 300)):
        tr, jr = run_of(raw, counts_n, source=r % counts_n)
        for st in (t, plain):
            st.add_run(*tr, source=r % counts_n)
        j.add_run(*jr)
    j._flush_deferred()
    assert len(t._spilled) == m and not t._runs
    plain.flush()
    slices = []
    merge_range = CountStore._merge_range

    def count_slices(self, parts):
        slices.append(len(parts))
        return merge_range(self, parts)

    monkeypatch.setattr(CountStore, "_merge_range", count_slices)
    b3 = []
    merge = tcs.cuda_merge.merge
    monkeypatch.setattr(tcs.cuda_merge, "merge",
                        lambda *a: b3.append(a[2]) or merge(*a))
    assert_same(t, j, plain)
    tm = t.timings
    assert tm["ranged_folds"] == 1 and tm["fold_merges"] == 0
    assert tm["ranges"] == len(slices) >= 2
    assert tm["range_rounds"] == sum((s - 1).bit_length() for s in slices)
    assert tm["range_rounds"] == len(b3)
    if case == "repeated splitters":
        # a range a row: more ranges than the largest run has rows, so
        # splitters repeat and their ranges are empty
        assert len(slices) < tm["rejoined_rows"]
    else:
        assert set(slices) == {m}
    for max_count in (1, 3):
        np.testing.assert_array_equal(t.spectrum(max_count),
                                      plain.spectrum(max_count))


def test_flush_seeds_from_a_spilled_run_without_the_ranged_fold():
    t = CountStore(21, spill_bytes=0, device="cpu")
    eager = CountStore(21, device="cpu")
    for raw, valid in kmer_batches(3, 21, 3, 400):
        tr, _ = run_of(raw[valid])
        t.add_run(*tr)
        eager.add_run(*tr)
    assert not t._runs and len(t._spilled) == 3
    before = t.timings["fold_merges"]
    assert t.counts_dict() == eager.counts_dict()
    assert t.timings["fold_merges"] == before + 2  # seed, then two rejoins
    assert t.timings["ranged_folds"] == 0


def test_fold_budget_default_and_override(monkeypatch):
    monkeypatch.delenv("KMH_FOLD_BUDGET_BYTES", raising=False)
    cpu = torch.device("cpu")
    assert tcs._fold_budget_bytes(cpu) >= 1 << 60  # no device to protect
    t = CountStore(21, spill_bytes=0, device="cpu")
    assert not t._ranged_fold_needed(10 ** 12)
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", "800")  # read at call time
    assert tcs._fold_budget_bytes(cpu) == 800
    assert t._ranged_fold_needed(11) and not t._ranged_fold_needed(10)


@pytest.mark.parametrize("ranged", [False, True])
def test_checkpoint_of_a_spilled_store_is_the_jax_file(ranged, tmp_path,
                                                       monkeypatch):
    """Saving folds the spilled runs first: both packages write the same
    arrays, and each loads the other's file."""
    if ranged:
        monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", "4096")
    t, j, eager = trio(21, counts_n=2, spill_bytes=4096)
    drive(t, j, eager, 61, 21)
    assert t._spilled and j._spilled
    tckpt.save_count_store(t, tmp_path / "t.npz")
    jckpt.save_count_store(j, tmp_path / "j.npz")
    assert not t._spilled
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        for name in ("u_hi", "u_lo", "cnt", "total_added"):
            np.testing.assert_array_equal(a[name], b[name])
    back = tckpt.load_count_store(tmp_path / "j.npz", device="cpu")
    assert back.counts_dict() == eager.counts_dict()
    assert (jckpt.load_count_store(tmp_path / "t.npz").counts_dict()
            == eager.counts_dict())
