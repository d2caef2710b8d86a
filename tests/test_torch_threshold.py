"""The per-base-threshold path — ``threshold_scan``, ``count_kmers_fq``,
``count_kmers_fq_sh`` — and the exact-C depth track, port against JAX
package and against the sequential oracle ``refsem`` on the same inputs.
All outputs are integer or boolean tables: equality is exact. The JAX
package's native reader is switched off, so both sides parse alike."""
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu import counting as jcounting
from kmer_hasher_tpu import refsem as rs
from kmer_hasher_tpu.ops import scan_iter as jsi
from kmer_hasher_tpu_torch import api, counting
from kmer_hasher_tpu_torch.ops import scan_iter as si

MIN_Q = 20
QC = 33 + MIN_Q


@pytest.fixture(autouse=True)
def pure_python_reader(monkeypatch):
    monkeypatch.setenv("KMH_NATIVE_IO", "0")


def make_reads(seed, k, n=120, lmax=70):
    """Reads with both cases, N runs, lengths <= k, and qualities around
    min_q: exactly min_q (passes a build, fails a roll), one below, above."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("ACGT"), size=300)
    recs = []
    for i in range(n):
        L = int(rng.integers(k + 1, lmax + 1))
        if i % 13 == 0:
            L = int(rng.integers(1, k + 1))  # holds no window at all
        a = int(rng.integers(0, len(genome) - L))
        s = genome[a: a + L].copy()
        if i % 3 == 0:
            s = np.char.lower(s)
        if i % 4 == 0:
            b = int(rng.integers(0, L))
            s[b: b + int(rng.integers(1, 4))] = "N"
        q = rng.choice([QC - 1, QC, QC + 1, QC + 15], size=L,
                       p=[0.03, 0.12, 0.15, 0.70])
        recs.append((f"r{i}", "".join(s), "".join(map(chr, q))))
    return recs


def pad(recs):
    L = max(len(r[1]) for r in recs)
    seq = np.full((len(recs), L), ord("N"), np.uint8)
    qual = np.zeros((len(recs), L), np.uint8)
    lengths = np.zeros(len(recs), np.int32)
    for i, (_n, s, q) in enumerate(recs):
        seq[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
        if q is not None:
            qual[i, :len(s)] = np.frombuffer(q.encode(), np.uint8)
        lengths[i] = len(s)
    return seq, qual, lengths


def lanes_to_raw(hi, lo):
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).view(np.int64)


@pytest.mark.parametrize("has_qual", [True, False])
@pytest.mark.parametrize("k", [5, 16, 21, 32])
def test_threshold_scan_matches_jax_and_the_oracle(k, has_qual):
    recs = make_reads(k, k, lmax=max(70, k + 30))
    seq, qual, lengths = pad(recs)
    emit, fwd, rc = si.threshold_scan(
        torch.from_numpy(seq), torch.from_numpy(qual),
        torch.from_numpy(lengths), k, QC, has_qual=has_qual)
    j = jsi.threshold_scan(jnp.asarray(seq), jnp.asarray(qual),
                           jnp.asarray(lengths), k, jnp.asarray(QC),
                           has_qual=has_qual)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(fwd.numpy(), lanes_to_raw(j[1], j[2]))
    np.testing.assert_array_equal(rc.numpy(), lanes_to_raw(j[3], j[4]))
    assert emit.any()
    for i, (_n, s, q) in enumerate(recs):
        want = []
        if len(s) > k:
            want = list(rs.iter_kmers_qual_threshold(
                s.encode(), q.encode() if has_qual else None, k, QC))
        at = np.flatnonzero(emit[i].numpy())
        assert (at + 1).tolist() == [w[0] for w in want], s
        got_f = fwd[i].numpy().view(np.uint64)[at].tolist()
        got_r = rc[i].numpy().view(np.uint64)[at].tolist()
        assert got_f == [w[1] for w in want]
        assert got_r == [w[2] for w in want]


def test_threshold_scan_gates_at_exactly_min_q():
    """q == min_q passes a build (>=) and fails a roll (>); the failed roll
    starts a new build at that very base; a build that completes on the
    read's last base is dropped."""
    k = 3
    seq = "ACGTACGTAC"
    cases = {
        # all above: one build, then rolls to the end
        "IIIIIIIIII": [3, 4, 5, 6, 7, 8, 9, 10],
        # min_q inside the first window: the build takes it
        "I5IIIIIIII".replace("5", chr(QC)): [3, 4, 5, 6, 7, 8, 9, 10],
        # min_q at a roll: the roll fails, a build restarts AT that base
        "IIII5IIIII".replace("5", chr(QC)): [3, 4, 7, 8, 9, 10],
        # below min_q: the build restarts after it
        "IIII4IIIII".replace("4", chr(QC - 1)): [3, 4, 8, 9, 10],
        # the last build completes on the last base: dropped
        "IIIIII4III".replace("4", chr(QC - 1)): [3, 4, 5, 6],
    }
    for qual, ends in cases.items():
        s, q, n = pad([("r", seq, qual)])
        emit, _f, _r = si.threshold_scan(torch.from_numpy(s),
                                         torch.from_numpy(q),
                                         torch.from_numpy(n), k, QC)
        assert (np.flatnonzero(emit[0].numpy()) + 1).tolist() == ends, qual
        want = [w[0] for w in rs.iter_kmers_qual_threshold(
            seq.encode(), qual.encode(), k, QC)]
        assert want == ends, qual
    with pytest.raises(ValueError):
        si.threshold_scan(torch.zeros((2, 4), dtype=torch.uint8),
                          torch.zeros((2, 5), dtype=torch.uint8),
                          torch.zeros(2), 3, QC)


def write_reads(path, recs, gz=False):
    """FASTQ records, or FASTA for a record without qualities."""
    text = "".join(f"@{n}\n{s}\n+\n{q}\n" if q is not None else f">{n}\n{s}\n"
                   for n, s, q in recs)
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(text.encode())
    else:
        path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("thr")
    out = {}
    for k in (5, 21, 32):
        recs = make_reads(10 + k, k, lmax=max(70, k + 40))
        out[k, "fq"] = (write_reads(d / f"r{k}.fq", recs), recs)
        out[k, "gz"] = (write_reads(d / f"r{k}.fq.gz", recs, gz=True), recs)
    noq = [(n, s, None) for n, s, _q in out[21, "fq"][1][:40]]
    out[21, "fa"] = (write_reads(d / "r21.fa", noq), noq)
    out["dir"] = d
    return out


def oracle_dict(store):
    return {kk: v for kk, v in store.counts.items()}


def assert_same(t, j, want):
    assert t.counts_dict() == j.counts_dict()
    assert t.counts_dict() == oracle_dict(want)
    np.testing.assert_array_equal(t.total_added, np.asarray(j.total_added))
    assert (t.prefix_bits, t.suffix_bits) == (j.prefix_bits, j.suffix_bits)
    for max_count in (3, 60):
        np.testing.assert_array_equal(api.kmer_spectrum(t, max_count),
                                      japi.kmer_spectrum(j, max_count))


@pytest.mark.parametrize("kind", ["fq", "gz"])
@pytest.mark.parametrize("k,min_q", [(5, MIN_Q), (21, MIN_Q), (21, 0),
                                     (32, MIN_Q)])
def test_count_kmers_fq_sh_matches_jax_and_the_oracle(files, k, min_q, kind):
    path, recs = files[k, kind]
    t = api.count_kmers_fq_sh(path, k=k, min_q=min_q, device="cpu")
    j = japi.count_kmers_fq_sh(path, k=k, min_q=min_q)
    want = rs.count_kmers_reads_threshold(
        [(s.encode(), q.encode()) for _n, s, q in recs], k=k,
        min_q_phred=min_q)
    assert t.mode == "sh" and t.n_unique > 20
    assert_same(t, j, want)


@pytest.mark.parametrize("k,prefix_bits", [(5, 4), (21, 16), (32, 16)])
def test_count_kmers_fq_matches_jax_with_zero_cells(files, k, prefix_bits):
    path, recs = files[k, "fq"]
    t = api.count_kmers_fq(path, k=k, min_q=MIN_Q, prefix_bits=prefix_bits,
                           device="cpu")
    j = japi.count_kmers_fq(path, k=k, min_q=MIN_Q, prefix_bits=prefix_bits)
    want = rs.count_kmers_reads_threshold(
        [(s.encode(), q.encode()) for _n, s, q in recs], k=k,
        min_q_phred=MIN_Q)
    assert t.mode == "ktree"
    assert_same(t, j, want)
    assert api.kmer_spectrum(t, 5)[0] > 0  # zero cells of allocated blocks


def test_records_without_qualities_and_max_reads(files, monkeypatch):
    k = 21
    path, recs = files[k, "fa"]
    monkeypatch.setattr(counting, "BATCH_ROWS", 16)  # three batches
    t = api.count_kmers_fq_sh(path, k=k, min_q=MIN_Q, device="cpu")
    j = japi.count_kmers_fq_sh(path, k=k, min_q=MIN_Q)
    want = rs.count_kmers_reads_threshold(
        [(s.encode(), None) for _n, s, _q in recs], k=k, min_q_phred=MIN_Q)
    assert_same(t, j, want)
    assert t.timings["tier_merges"] >= 1
    # a second file into the same store, and a read limit
    path2, recs2 = files[k, "fq"]
    t = api.count_kmers_fq_sh(path2, k=k, min_q=MIN_Q, max_reads=50, store=t)
    j = japi.count_kmers_fq_sh(path2, k=k, min_q=MIN_Q, max_reads=50, store=j)
    want = rs.count_kmers_reads_threshold(
        [(s.encode(), q.encode()) for _n, s, q in recs2[:50]], k=k,
        min_q_phred=MIN_Q, store=want)
    assert_same(t, j, want)


@pytest.mark.parametrize("entry", ["count_kmers_fq", "count_kmers_fq_sh"])
def test_a_jax_store_handed_over_keeps_counting(files, monkeypatch, entry):
    """The JAX package counts one file; its live rows go to the port through
    ``count_store_from_numpy``; both then count a second file in small
    batches (tier merges and a fold onto the handed-over base table) and a
    saved checkpoint goes back the other way."""
    from kmer_hasher_tpu.utils import checkpoint as jckpt
    from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

    k = 21
    j = getattr(japi, entry)(files[k, "fq"][0], k=k, min_q=MIN_Q)
    n = j.n_unique
    meta = {"k": j.k, "counts_n": j.counts_n, "prefix_bits": j.prefix_bits,
            "suffix_bits": j.suffix_bits, "mode": j.mode}
    t = tckpt.count_store_from_numpy(
        meta, np.asarray(j.u_hi)[:n], np.asarray(j.u_lo)[:n],
        np.asarray(j.cnt)[:n], j.total_added, device="cpu")
    monkeypatch.setattr(counting, "BATCH_ROWS", 8)
    t = getattr(api, entry)(files[k, "fa"][0], k=k, min_q=MIN_Q, store=t)
    j = getattr(japi, entry)(files[k, "fa"][0], k=k, min_q=MIN_Q, store=j)
    assert t.timings["tier_merges"] >= 2 and t.mode == j.mode
    recs = files[k, "fq"][1] + files[k, "fa"][1]
    want = rs.count_kmers_reads_threshold(
        [(s.encode(), q.encode() if q else None) for _n, s, q in recs], k=k,
        min_q_phred=MIN_Q)
    assert_same(t, j, want)
    tckpt.save_count_store(t, files["dir"] / f"{entry}.npz")
    back = jckpt.load_count_store(files["dir"] / f"{entry}.npz")
    assert back.counts_dict() == j.counts_dict() and back.mode == j.mode


def test_mixed_batch_matches_the_jax_batch_function():
    """One batch with and without qualities through both
    ``_fused_threshold_batch`` functions."""
    from kmer_hasher_tpu.index.count_store import CountStore as JaxStore

    k = 11
    recs = make_reads(3, k, n=63)
    seq, qual, lengths = pad(recs)
    L = -(-seq.shape[1] // 64) * 64  # the JAX package's batches: 64-columns
    seq = np.pad(seq, ((0, 0), (0, L - seq.shape[1])),
                 constant_values=ord("N"))
    qual = np.pad(qual, ((0, 0), (0, L - qual.shape[1])))
    has_qual = np.arange(len(recs)) % 3 != 1
    n_win = counting.win_bucket(int(lengths.max()), k)
    j = JaxStore(k)
    r = jcounting._fused_threshold_batch(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
        jnp.asarray(has_qual), k, 1, QC, True, True,
        keyonly=j.keyonly_runs, n_win=n_win)
    j.add_run(*r)
    t = api.CountStore(k, device="cpu")
    t.add_run(*counting._fused_threshold_batch(
        *(torch.from_numpy(a) for a in (seq, qual, lengths, has_qual)), k, 1,
        QC, True, True, n_win=n_win))
    assert t.counts_dict() == j.counts_dict() and t.n_unique > 20
    np.testing.assert_array_equal(t.total_added, np.asarray(j.total_added))


def test_threshold_argument_checks(files):
    path, _recs = files[5, "fq"]
    for entry in (api.count_kmers_fq, api.count_kmers_fq_sh):
        with pytest.raises(ValueError):
            entry(path, k=33, device="cpu")
        with pytest.raises(ValueError):
            entry(path, k=0, device="cpu")
    drop = api.count_kmers_fq(path, k=5, max_mem_gb=1,
                              budget_semantics="drop", device="cpu")
    assert drop.budget_semantics == "drop" and drop.n_unique > 0
    with pytest.raises(ValueError, match="requires"):  # no budget to keep
        api.count_kmers_fq(path, k=5, budget_semantics="drop", device="cpu")
    with pytest.raises(MemoryError):
        st = api.CountStore(5, mode="ktree", prefix_bits=4, suffix_bits=6,
                            max_size_bytes=64, device="cpu")
        api.count_kmers_fq(path, k=5, store=st)
    assert set(japi.__all__) <= set(api.__all__)


# -- the exact-C depth track --------------------------------------------------

def depth_queries(base, k, rng):
    unit = base[:k]
    qs = [
        base,                                        # no N at all
        unit + "N" + base[:30],                      # exactly-k head: stale
        base[:25] + "NN" + unit + "N" + base[30:60],  # stale in the middle
        unit + "N" + "GGA"[:k - 1] + "NN" + base[:20],  # stale, short region
        base[:20] + "NNN",                           # trailing Ns
        base[:20] + "N" + "GGA"[:k - 1],             # trailing short region
        unit + "N",                                  # exactly k, then N
        "N" * 7,                                     # all N
        "GGA"[:k - 1],                               # n < k: all NA
        "AC" + "N" + "GG",                           # only short regions
        unit,                                        # exactly k, no N
        unit + "n" + unit + "N" + unit,              # stale after stale
    ]
    for _ in range(25):  # N-riddled random strings
        L = int(rng.integers(k, 70))
        qs.append("".join(rng.choice(list("ACGTN"), size=L,
                                     p=[.22, .22, .22, .22, .12])))
    return qs


@pytest.mark.parametrize("k", [3, 5, 13])
def test_depth_c_matches_jax_and_the_oracle(k):
    rng = np.random.default_rng(k)
    base = "".join(rng.choice(list("ACGT"), size=90))
    reads = [base[a: a + 40] for a in range(0, 50, 5)] * 2
    t = api.count_kmers(reads, k, source=1, source_n=2, device="cpu")
    j = japi.count_kmers(reads, k, source=1, source_n=2)
    want_st = rs.count_kmers_seqs(reads, k, 1, 2)
    for q in depth_queries(base, k, rng):
        got = api.seq_kmer_depth(t, q, k, semantics="c")
        assert got.dtype == torch.int32 and got.shape == (2, len(q))
        np.testing.assert_array_equal(
            got.numpy(), jcounting._seq_kmer_depth_c(
                j, np.frombuffer(q.encode(), np.uint8), k), err_msg=q)
        np.testing.assert_array_equal(
            got.numpy(), rs.seq_kmer_depth(want_st, q, k, semantics="c"),
            err_msg=q)


def test_depth_c_at_k32_and_from_bytes_arrays_and_tensors():
    k = 32
    rng = np.random.default_rng(32)
    base = "".join(rng.choice(list("ACGT"), size=200))
    t = api.count_kmers([base, "G" * 40], k, device="cpu")
    j = japi.count_kmers([base, "G" * 40], k)
    q = base[:32] + "N" + base[40:90] + "N" + "G" * 36 + "NN" + base[5:20]
    want = japi.seq_kmer_depth(j, q, k, semantics="c")
    arr = np.frombuffer(q.encode(), np.uint8)
    for form in (q, q.encode(), arr, torch.from_numpy(arr.copy())):
        np.testing.assert_array_equal(
            api.seq_kmer_depth(t, form, k, semantics="c").numpy(), want)
    assert (want > 0).any()
    with pytest.raises(ValueError):
        api.seq_kmer_depth(t, q, k, semantics="d")
