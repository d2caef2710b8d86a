"""Kernel B3's plain version, the port's hierarchical merge sort and the
``KMH_MERGE_SORT=1`` route of ``sort_windows`` against the JAX package:
its XLA bitonic round, its Pallas merge kernel in interpret mode and
``lax.sort``. Everything is integer data, so equality is exact. The port
holds a key as a sortable int64 (``raw ^ 2^63``) and the 32-bit payload in
an int32 tensor compared as unsigned; the JAX package holds uint64 and
uint32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.ops import merge_sort as jms
from kmer_hasher_tpu.ops import sort as jsrt
from kmer_hasher_tpu_torch.ops import cuda_merge
from kmer_hasher_tpu_torch.ops import merge_sort as ms
from kmer_hasher_tpu_torch.ops import sort as srt

SIGN = np.uint64(1 << 63)
FIVE_KEYS = [0, 1, 2 ** 63, 2 ** 64 - 1, 42]  # repeat-dominated: adversarial


def rand_pairs(n, seed, dup_heavy=False, pay_bits=32):
    """(uint64 keys, uint32 payloads): random, or five distinct keys over
    all n elements; payloads a permutation, optionally with bit 31 set on
    every third (the k = 32 index payload's flag)."""
    rng = np.random.default_rng(seed)
    if dup_heavy:
        keys = rng.choice(np.array(FIVE_KEYS, np.uint64), size=n)
    else:
        keys = rng.integers(0, 2 ** 64 - 1, size=n, dtype=np.uint64)
    pay = rng.permutation(n).astype(np.uint32)
    if pay_bits == 32:
        pay[::3] |= np.uint32(1 << 31)
    return keys, pay


def to_port(keys_u64, pay_u32):
    return (torch.from_numpy((keys_u64 ^ SIGN).view(np.int64)),
            torch.from_numpy(pay_u32.view(np.int32).copy()))


def from_port(k, p):
    return (k.numpy().view(np.uint64) ^ SIGN, p.numpy().view(np.uint32))


def sorted_rows(keys, pay, L):
    """[R, L] rows, each sorted by (key, payload), as phase 1 leaves them."""
    k, p = jax.lax.sort((jnp.asarray(keys.reshape(-1, L)),
                         jnp.asarray(pay.reshape(-1, L))),
                        dimension=-1, num_keys=2)
    return np.asarray(k), np.asarray(p)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("R,L", [(2, 512), (8, 256), (16, 64)])
def test_plain_round_matches_bitonic_round_and_lax_sort(R, L, dup):
    keys, pay = rand_pairs(R * L, R + L, dup)
    k, p = sorted_rows(keys, pay, L)
    got = from_port(*cuda_merge.merge(*to_port(k.reshape(-1), p.reshape(-1)),
                                      np.arange(0, R * L + 1, L)))
    wk, wp = jms._merge_round_bitonic(jnp.asarray(k), jnp.asarray(p))
    np.testing.assert_array_equal(got[0], np.asarray(wk).reshape(-1))
    np.testing.assert_array_equal(got[1], np.asarray(wp).reshape(-1))
    lk, lp = jax.lax.sort((jnp.asarray(k.reshape(R // 2, 2 * L)),
                           jnp.asarray(p.reshape(R // 2, 2 * L))),
                          dimension=-1, num_keys=2)
    np.testing.assert_array_equal(got[0], np.asarray(lk).reshape(-1))
    np.testing.assert_array_equal(got[1], np.asarray(lp).reshape(-1))


@pytest.mark.parametrize("dup", [False, True])
def test_sort_kmers_merge_matches_pallas_interpret_and_lax_sort(dup):
    n, Lt, T = 1 << 13, 1 << 11, 1 << 9
    keys, pay = rand_pairs(n, 7 + dup, dup)
    got = from_port(*ms.sort_kmers_merge(*to_port(keys, pay), Lt=Lt))
    jk, jp = jms.sort_kmers_merge(jnp.asarray(keys), jnp.asarray(pay), Lt=Lt,
                                  T=T, use_kernel=True, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(jk))
    np.testing.assert_array_equal(got[1], np.asarray(jp))
    lk, lp = jax.lax.sort((jnp.asarray(keys), jnp.asarray(pay)), num_keys=2)
    np.testing.assert_array_equal(got[0], np.asarray(lk))
    np.testing.assert_array_equal(got[1], np.asarray(lp))


@pytest.mark.parametrize("n,Lt,seed,dup", [(1 << 14, 1 << 11, 0, False),
                                           (1 << 14, 1 << 11, 1, True),
                                           (1 << 16, 1 << 12, 2, False)])
def test_sort_kmers_merge_matches_jax_bitonic_path(n, Lt, seed, dup):
    keys, pay = rand_pairs(n, seed, dup)
    got = from_port(*ms.sort_kmers_merge(*to_port(keys, pay), Lt=Lt))
    jk, jp = jms.sort_kmers_merge(jnp.asarray(keys), jnp.asarray(pay), Lt=Lt)
    np.testing.assert_array_equal(got[0], np.asarray(jk))
    np.testing.assert_array_equal(got[1], np.asarray(jp))


@pytest.mark.parametrize("n", [1 << 8, 3 << 10, (1 << 12) + 64])
def test_sizes_off_the_merge_path_take_the_ordinary_sort(n, monkeypatch):
    """The JAX package's own condition: too small, not a multiple of Lt or
    not a power of two -> no merge round runs, same answer."""
    def no_merge(*a, **kw):
        raise AssertionError("a merge round ran")

    monkeypatch.setattr(cuda_merge, "merge", no_merge)
    keys, pay = rand_pairs(n, n)
    got = from_port(*ms.sort_kmers_merge(*to_port(keys, pay), Lt=1 << 10))
    lk, lp = jax.lax.sort((jnp.asarray(keys), jnp.asarray(pay)), num_keys=2)
    np.testing.assert_array_equal(got[0], np.asarray(lk))
    np.testing.assert_array_equal(got[1], np.asarray(lp))


def test_merge_rounds_run_log2_r_times(monkeypatch):
    calls = []
    real = cuda_merge.merge

    def counted(k, p, b):
        calls.append(len(b))
        return real(k, p, b)

    monkeypatch.setattr(cuda_merge, "merge", counted)
    ms.sort_kmers_merge(*to_port(*rand_pairs(1 << 12, 3)), Lt=1 << 8)
    assert calls == [17, 9, 5, 3]  # 16 runs -> 4 rounds, 2P + 1 bounds each


def test_merge_path_splits_match_jax_and_the_defining_inequalities():
    rng = np.random.default_rng(1)
    L, T = 1 << 10, 1 << 7
    a = np.sort(rng.integers(0, 1 << 20, L).astype(np.uint64))
    b = np.sort(rng.integers(0, 1 << 20, L).astype(np.uint64))
    ap = bp = np.arange(L, dtype=np.uint32)
    want = np.asarray(jms.merge_path_splits(
        jnp.asarray(a), jnp.asarray(ap), jnp.asarray(b), jnp.asarray(bp), T))
    ak, tap = to_port(a, ap)
    bk, tbp = to_port(b, bp)
    splits = ms.merge_path_splits(ak, tap, bk, tbp, T).numpy()
    np.testing.assert_array_equal(splits, want)
    for t, i in enumerate(splits):
        r = t * T
        j = r - i
        assert 0 <= i <= L and 0 <= j <= L
        if i > 0 and j < L:
            assert (a[i - 1], ap[i - 1]) <= (b[j], bp[j])
        if j > 0 and i < L:
            assert (b[j - 1], bp[j - 1]) <= (a[i], ap[i])


RUN_LENGTHS = {
    "unequal": (700, 13, 5, 2049, 1, 1),
    "empty runs": (0, 9, 4, 0, 0, 0, 3, 3),
    "shorter than a tile": (3, 2),
    "one long, one of 1": (4097, 1),
}


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("case", sorted(RUN_LENGTHS))
def test_plain_merge_of_ragged_runs_is_the_python_merge(case, implicit):
    """Any run lengths; all-ones keys (a real value in the port) in both A
    and B with the flag bit of the payload deciding; A first on a tie."""
    rng = np.random.default_rng(len(case))
    lens = RUN_LENGTHS[case]
    vals = np.array(FIVE_KEYS + [7, 2 ** 62], np.uint64)
    runs = []
    for n in lens:
        k = rng.choice(vals, size=n)
        p = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64)
        order = np.lexsort((p, k))
        runs.append((k[order], p[order].astype(np.uint32)))
    keys = np.concatenate([r[0] for r in runs])
    pay = np.concatenate([r[1] for r in runs])
    bounds = np.concatenate([[0], np.cumsum(lens)])
    if implicit:
        pay = np.arange(len(keys), dtype=np.uint32)
    tk, tp = to_port(keys, pay)
    got = from_port(*cuda_merge.merge(tk, None if implicit else tp, bounds))
    want = []
    for i in range(0, len(lens), 2):
        lo, hi = bounds[i], bounds[i + 2]
        want += sorted(zip(keys[lo:hi].tolist(), pay[lo:hi].tolist()))
    assert list(zip(got[0].tolist(), got[1].tolist())) == want


def test_merge_rejects_what_it_does_not_take():
    k = torch.zeros(8, dtype=torch.int64)
    p = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_merge.merge(k.int(), p, (0, 4, 8))
    with pytest.raises(TypeError):
        cuda_merge.merge(k, p.long(), (0, 4, 8))
    with pytest.raises(TypeError):
        cuda_merge.merge(k, p[:4], (0, 4, 8))
    for bad in ((0, 8), (0, 4, 6, 8), (0, 5, 4), (1, 4, 8), (0, 4, 7)):
        with pytest.raises(ValueError):
            cuda_merge.merge(k, p, bad)


def windows(rng, n, k):
    """Raw k-mer patterns as (hi, lo) uint32 lanes with repeats, invalid
    windows, and for k = 32 real all-G 32-mers (all ones)."""
    top = (1 << (2 * k)) - 1
    raw = rng.integers(0, top, size=n, dtype=np.uint64, endpoint=True)
    raw[rng.integers(0, n, size=n // 4)] = raw[0]  # one k-mer recurs
    valid = rng.random(n) < 0.9
    if k == 32:
        at = rng.integers(0, n, size=6)
        raw[at] = np.uint64(top)
        valid[at[:4]] = True
        valid[at[4:]] = False
    return raw, valid


@pytest.mark.parametrize("k", [16, 21, 31, 32])
@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
def test_flagged_sort_windows_matches_jax_with_the_flag_on(monkeypatch, k, n):
    """n = 2^16 takes the merge rounds on both sides (Lt = 2^15); 2^12 the
    ordinary sort. k = 16 under the flag keeps the k <= 31 tail."""
    monkeypatch.setenv("KMH_MERGE_SORT", "1")
    rng = np.random.default_rng(100 * k + n % 97)
    raw, valid = windows(rng, n, k)
    hi = (raw >> np.uint64(32)).astype(np.uint32)
    lo = raw.astype(np.uint32)
    pos = np.arange(1, n + 1, dtype=np.int32)
    j_hi, j_lo, j_pos = jsrt.sort_windows.__wrapped__(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pos),
        jnp.asarray(valid), k)
    s_key, s_pos = srt.sort_windows(torch.from_numpy(raw.view(np.int64)),
                                    torch.from_numpy(valid), k)
    assert s_pos.dtype == torch.int32
    got = s_key.numpy().view(np.uint64) ^ SIGN
    want = (np.asarray(j_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        j_lo).astype(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(s_pos.numpy(), np.asarray(j_pos))
    monkeypatch.setenv("KMH_MERGE_SORT", "0")
    off_key, off_pos = srt.sort_windows(torch.from_numpy(raw.view(np.int64)),
                                        torch.from_numpy(valid), k)
    nv = int(valid.sum())
    assert torch.equal(s_key[:nv], off_key[:nv])
    assert torch.equal(s_pos[:nv], off_pos[:nv])
    if k > 16:  # the whole axis, invalid tail included
        assert torch.equal(s_key, off_key) and torch.equal(s_pos, off_pos)
    else:  # the packed form's tail differs, as in the JAX package
        assert not torch.equal(s_pos[nv:], off_pos[nv:])


def test_batched_sort_windows_ignores_the_flag(monkeypatch):
    rng = np.random.default_rng(4)
    raw, valid = windows(rng, 4 * 256, 21)
    key = torch.from_numpy(raw.view(np.int64)).reshape(4, 256)
    v = torch.from_numpy(valid).reshape(4, 256)
    monkeypatch.setenv("KMH_MERGE_SORT", "0")
    want = srt.sort_windows(key, v, 21)
    monkeypatch.setenv("KMH_MERGE_SORT", "1")
    got = srt.sort_windows(key, v, 21)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [16, 32])
def test_flagged_index_build_matches_jax(monkeypatch, k):
    """The whole build under the flag: the port's index equals the JAX
    package's, also flag on, over the live prefix and the tables."""
    from kmer_hasher_tpu import api as japi
    from kmer_hasher_tpu_torch import api

    monkeypatch.setenv("KMH_MERGE_SORT", "1")
    monkeypatch.setattr(ms, "LT", 1 << 8)  # 4096 windows: 4 merge rounds
    rounds = []
    real = cuda_merge.merge
    monkeypatch.setattr(cuda_merge, "merge",
                        lambda *a: rounds.append(1) or real(*a))
    rng = np.random.default_rng(k)
    seq = "".join(rng.choice(list("ACGTN"), size=3000,
                             p=[.24, .24, .24, .24, .04]))
    seq = seq[:1000] + "G" * 70 + seq[1000:1500] + seq[:400] + seq[1500:]
    t = api.make_kmer_hash(seq, k, device="cpu")
    j = japi.make_kmer_hash(seq, k)
    assert t.n_valid == j.n_valid and len(rounds) == 4
    tt, jt = api.kmer_pos(t, 15), japi.kmer_pos(j, 15)
    assert tt["kmer"] == list(jt["kmer"])
    for f in ("pos", "pair.pos", "count"):
        np.testing.assert_array_equal(tt[f].numpy(), np.asarray(jt[f]))
    # the JAX package's flagged arrays, handed over, are the port's own
    from kmer_hasher_tpu_torch.utils import checkpoint

    h = checkpoint.index_from_numpy(k, len(seq), j.s_hi, j.s_lo, j.s_pos,
                                    j.n_valid, device="cpu")
    for name in ("s_key", "s_pos", "starts", "seg_ids", "cum_m"):
        assert torch.equal(getattr(h, name), getattr(t, name)), name
