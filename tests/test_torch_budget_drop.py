"""kmer_tree budget 'drop' semantics of the port's CountStore
(src/kmer_tree.c:51-76) against the JAX package's store on the same
streams and runs, and against the sequential oracle of
tests/test_budget_drop.py: the counterparts of that file's six tests, plus
larger seeded streams at k = 21 and k = 32 and checkpoints loaded by the
other package, both ways. Everything is integer data: equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.index.count_store import CountStore as JaxStore
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch.index.count_store import CountStore
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

SIGN = -(2 ** 63)
GEOMETRY = dict(counts_n=1, prefix_bits=4, suffix_bits=4, mode="ktree")
BLOCK = 64  # k=4, suffix 4 bits: a block is 4 * 2^4 bytes
STREAM = [  # prefixes 1,2,1,3,2,1,4,3 (first come: 1, 2, 3, ...)
    0x12, 0x25, 0x13, 0x31, 0x2A, 0x12, 0x4F, 0x35,
]


def ktree_drop_oracle(kmers, b_max, suffix_bits):
    """The C budget walk, one k-mer at a time: a block is allocated on first
    sight of a prefix while fewer than b_max exist; a k-mer counts iff its
    prefix has a block."""
    admitted, counts, dropped = set(), {}, 0
    for km in kmers:
        p = km >> suffix_bits
        if p not in admitted:
            if len(admitted) < b_max:
                admitted.add(p)
            else:
                dropped += 1
                continue
        counts[km] = counts.get(km, 0) + 1
    return admitted, counts, dropped


def pair(k=4, **kw):
    kw = {**GEOMETRY, **kw}
    return CountStore(k, device="cpu", **kw), JaxStore(k, **kw)


def add_stream(t, j, kmers, source=0, defer=False):
    raw = np.asarray(kmers, np.uint64)
    ok = np.ones(len(raw), bool)
    t.add_kmers(torch.from_numpy(raw.view(np.int64)), torch.from_numpy(ok),
                source=source, defer=defer)
    j.add_kmers(jnp.asarray((raw >> np.uint64(32)).astype(np.uint32)),
                jnp.asarray(raw.astype(np.uint32)), jnp.asarray(ok),
                source=source, defer=defer)


def add_run(t, j, kmers, counts_n=1, source=0):
    """One sorted run of the k-mers' counts into both stores, each in its
    package's run form (the JAX one padded with all-ones dead rows)."""
    uniq, n = np.unique(np.asarray(kmers, np.uint64), return_counts=True)
    cnt = torch.zeros((len(uniq), counts_n), dtype=torch.int64)
    cnt[:, source] = torch.from_numpy(n)
    t.add_run(torch.from_numpy(uniq.view(np.int64)) ^ SIGN, cnt, len(kmers),
              source=source)
    cap = max(4, 1 << int(len(uniq) - 1).bit_length())
    hi = np.full(cap, 0xFFFFFFFF, np.uint32)
    lo = np.full(cap, 0xFFFFFFFF, np.uint32)
    jc = np.zeros((cap, counts_n), np.uint32)
    hi[: len(uniq)] = (uniq >> np.uint64(32)).astype(np.uint32)
    lo[: len(uniq)] = uniq.astype(np.uint32)
    jc[: len(uniq), source] = n
    n_obs = np.zeros(counts_n, np.int64)
    n_obs[source] = len(kmers)
    j.add_run(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(jc),
              jnp.asarray(n_obs), source=source)


def assert_same(t, j):
    assert t.counts_dict() == j.counts_dict()
    np.testing.assert_array_equal(t.total_added, np.asarray(j.total_added))
    np.testing.assert_array_equal(t.spectrum(10), j.spectrum(10))
    assert t.n_alloc_blocks() == j.n_alloc_blocks()
    np.testing.assert_array_equal(t._admitted, j._admitted)
    assert t._admitted.dtype == np.uint64
    assert t._admit_frozen == j._admit_frozen


def test_drop_stream_matches_oracle():
    """add_kmers carries true stream order: admission and counts equal the
    sequential C walk exactly, budget at 2 blocks."""
    t, j = pair(max_size_bytes=2 * BLOCK, budget_semantics="drop")
    add_stream(t, j, STREAM)
    admitted, counts, dropped = ktree_drop_oracle(STREAM, 2, 4)
    assert set(int(p) for p in t._admitted) == admitted  # {1, 2}
    assert t._admit_frozen
    assert {km: c[0] for km, c in t.counts_dict().items()} == counts
    assert int(t.total_added[0]) == len(STREAM) - dropped
    assert_same(t, j)
    # later batches: an admitted prefix still counts, new ones never do
    add_stream(t, j, [0x11, 0x77])
    got = {km: c[0] for km, c in t.counts_dict().items()}
    assert got == {**counts, 0x11: 1}
    spec = t.spectrum(10)  # zero cells come from the ADMITTED blocks only
    assert spec[1:].sum() == len(got) and spec[0] == 2 * 16 - len(got)
    assert_same(t, j)


def test_drop_run_path_matches_oracle_between_batches():
    """add_run agrees with the oracle whenever no single run straddles the
    budget boundary."""
    t, j = pair(max_size_bytes=2 * BLOCK, budget_semantics="drop")
    b1 = [0x12, 0x25, 0x13, 0x2A]  # prefixes {1, 2}: fills the budget
    b2 = [0x31, 0x12, 0x4F, 0x35]  # {3, 4} all dropped, 0x12 kept
    for batch in (b1, b2):
        add_run(t, j, batch)
    admitted, counts, dropped = ktree_drop_oracle(b1 + b2, 2, 4)
    assert set(int(p) for p in t._admitted) == admitted
    assert {km: c[0] for km, c in t.counts_dict().items()} == counts
    assert int(t.total_added[0]) == len(b1 + b2) - dropped
    assert_same(t, j)


def test_drop_boundary_run_admits_in_key_order():
    """A single run straddling the budget admits in key order (the JAX
    package's PARITY deviation 7): budget 2, one run with prefixes {3, 1, 2}
    admits {1, 2}; the same k-mers as a stream admit {3, 1}."""
    t, j = pair(max_size_bytes=2 * BLOCK, budget_semantics="drop")
    add_run(t, j, [0x33, 0x15, 0x27])
    assert sorted(int(p) for p in t._admitted) == [1, 2]
    assert t._admit_frozen
    assert int(t.total_added[0]) == 2 and t.n_unique == 2
    assert_same(t, j)
    t, j = pair(max_size_bytes=2 * BLOCK, budget_semantics="drop")
    add_stream(t, j, [0x33, 0x15, 0x27])
    assert sorted(int(p) for p in t._admitted) == [1, 3]
    assert_same(t, j)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_drop_checkpoint_roundtrip(saver, tmp_path):
    """The admitted set and the frozen flag survive save and load, within
    the port and across the packages both ways: a resumed run keeps
    dropping exactly the same prefixes."""
    t, j = pair(max_size_bytes=2 * BLOCK, budget_semantics="drop")
    add_stream(t, j, STREAM)
    p = str(tmp_path / "drop.npz")
    if saver == "port":
        tckpt.save_count_store(t, p)
    else:
        jckpt.save_count_store(j, p)
    t2 = tckpt.load_count_store(p, device="cpu")
    j2 = jckpt.load_count_store(p)
    for back in (t2, j2):
        assert back.budget_semantics == "drop" and back._admit_frozen
        assert back.max_size_bytes == 2 * BLOCK and back.mode == "ktree"
        np.testing.assert_array_equal(back._admitted, t._admitted)
    assert_same(t2, j2)
    add_stream(t2, j2, [0x11, 0x77])  # 0x7? is still dropped after a resume
    got = t2.counts_dict()
    assert 0x11 in got and not any(km >> 4 == 7 for km in got)
    assert_same(t2, j2)


def test_drop_mode_validation():
    for make in (lambda **kw: CountStore(4, device="cpu", **kw),
                 lambda **kw: JaxStore(4, **kw)):
        with pytest.raises(ValueError, match="budget_semantics"):
            make(**GEOMETRY, max_size_bytes=64, budget_semantics="nope")
        with pytest.raises(ValueError, match="requires"):
            make(**GEOMETRY, budget_semantics="drop")  # no max_size_bytes
        with pytest.raises(ValueError, match="requires"):
            make(mode="sh", max_size_bytes=64, budget_semantics="drop")


def test_error_mode_unchanged():
    """The default budget semantics still raise in both packages."""
    t, j = pair(max_size_bytes=1 * BLOCK)  # one block
    with pytest.raises(MemoryError, match="budget"):
        add_stream(t, JaxStore(4, **GEOMETRY), STREAM)
    with pytest.raises(MemoryError, match="budget"):
        add_stream(CountStore(4, device="cpu", **GEOMETRY), j, STREAM)
    assert t._admitted is None  # no admission walk outside drop mode


@pytest.mark.parametrize("k,prefix_bits", [(21, 12), (32, 34)])
def test_drop_seeded_streams_and_runs_two_sources(k, prefix_bits):
    """Seeded k-mers with a real all-G k-mer, two sources, eager and
    deferred streams and prebuilt runs mixed: the port equals the JAX store
    and, for the stream part, the oracle; total_added loses exactly the
    dropped observations of each source."""
    rng = np.random.default_rng(k)
    sb = 2 * k - prefix_bits
    top = (1 << (2 * k)) - 1
    prefixes = rng.integers(0, 1 << prefix_bits, size=12, dtype=np.uint64)
    prefixes[0] = (1 << prefix_bits) - 1  # all-G's prefix

    def draw(n):
        low = rng.integers(0, 1 << min(sb, 6), size=n, dtype=np.uint64)
        kmers = (prefixes[rng.integers(0, 12, size=n)] << np.uint64(sb)) | low
        kmers[0] = top  # the all-G k-mer itself
        return kmers

    block = 4 << sb
    kw = dict(counts_n=2, prefix_bits=prefix_bits, suffix_bits=sb,
              mode="ktree", max_size_bytes=5 * block,
              budget_semantics="drop")
    t, j = pair(k, **kw)
    first = draw(40)[:4]  # a few prefixes only: the budget is not full yet
    add_stream(t, j, first, source=0)
    assert not t._admit_frozen
    second = draw(300)
    add_stream(t, j, second, source=1, defer=True)
    admitted, counts, dropped = ktree_drop_oracle(
        [int(x) for x in np.concatenate([first, second])], 5, sb)
    assert t._admit_frozen
    assert set(int(p) for p in t._admitted) == admitted
    assert {km: sum(c) for km, c in t.counts_dict().items()} == counts
    assert int(t.total_added.sum()) == len(first) + len(second) - dropped
    assert_same(t, j)
    add_run(t, j, draw(200), counts_n=2, source=0)
    add_stream(t, j, draw(100), source=1, defer=True)
    add_run(t, j, draw(150), counts_n=2, source=1)
    assert_same(t, j)
    assert int(t.cnt.sum()) == int(t.total_added.sum())
    assert top in t.counts_dict()  # all-G is a k-mer like any other
    assert t.n_alloc_blocks() <= 5


def test_drop_through_count_kmers_fq_matches_jax(tmp_path):
    """count_kmers_fq(budget_semantics="drop") through both packages."""
    from kmer_hasher_tpu import api as japi
    from kmer_hasher_tpu_torch import api

    rng = np.random.default_rng(2)
    path = tmp_path / "reads.fq"
    with open(path, "w") as f:
        for i in range(60):
            n = int(rng.integers(20, 60))
            seq = "".join(rng.choice(list("ACGT"), size=n))
            qual = "".join(chr(33 + int(q))
                           for q in rng.integers(5, 41, size=n))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    stores = []
    for drop in (True, False):
        kw = dict(k=9, min_q=10, prefix_bits=8)
        st = api.CountStore(9, mode="ktree", prefix_bits=8, suffix_bits=10,
                            max_size_bytes=40 * (4 << 10),
                            budget_semantics="drop" if drop else "error",
                            device="cpu")
        js = JaxStore(9, mode="ktree", prefix_bits=8, suffix_bits=10,
                      max_size_bytes=40 * (4 << 10),
                      budget_semantics="drop" if drop else "error")
        if drop:
            api.count_kmers_fq(str(path), store=st, **kw)
            japi.count_kmers_fq(str(path), store=js, **kw)
            assert_same(st, js)
            assert st._admit_frozen and st.n_alloc_blocks() == 40
        else:
            with pytest.raises(MemoryError):
                api.count_kmers_fq(str(path), store=st, **kw)
        stores.append(st)
    # with max_mem_gb the entry builds the drop store itself
    st = api.count_kmers_fq(str(path), k=9, min_q=10, prefix_bits=8,
                            max_mem_gb=1, budget_semantics="drop",
                            device="cpu")
    assert st.budget_semantics == "drop" and not st._admit_frozen
