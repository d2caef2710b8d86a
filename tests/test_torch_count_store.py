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
    with pytest.raises(NotImplementedError):
        CountStore(21, mode="ktree", max_size_bytes=1 << 20,
                   budget_semantics="drop", device="cpu")
    with pytest.raises(NotImplementedError):
        CountStore(21, spill_bytes=1 << 20, device="cpu")
    with pytest.raises(NotImplementedError):
        CountStore(21, spill_dir="/tmp/x", device="cpu")
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
