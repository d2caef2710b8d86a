"""The counting slice as a whole, port against JAX package on the same
synthetic files: ``count_kmers_fq_sh_rp`` in its three likelihood modes,
file lists, sources, skip/max/resume, ``count_kmers``, spectra and the
depth track. All outputs are integer tables: equality is exact."""
import gzip

import numpy as np
import pytest
import torch

from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch import api, counting
from kmer_hasher_tpu_torch.parallel import make_mesh
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt


def make_reads(seed, n=150, lmin=20, lmax=80, k=15):
    """Reads drawn from a short genome (so k-mers recur), both cases, some
    with N, some of length <= k, NovaSeq-binned qualities with a few
    low-quality stretches."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("ACGT"), size=400)
    recs = []
    for i in range(n):
        L = int(rng.integers(lmin, lmax + 1))
        if i % 17 == 0:
            L = int(rng.integers(1, k + 1))  # too short to hold a window
        a = int(rng.integers(0, len(genome) - L))
        s = genome[a: a + L].copy()
        if i % 3 == 0:
            s = np.char.lower(s)
        if i % 5 == 0:
            s[int(rng.integers(0, L))] = "N"
        q = rng.choice(list("F:,#"), size=L, p=[0.88, 0.08, 0.02, 0.02])
        if i % 11 == 0:
            b = int(rng.integers(0, L))
            q[b: b + 6] = "#"
        recs.append((f"r{i}", "".join(s), "".join(q)))
    return recs


def write_fastq(path, recs, gz=False):
    text = "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in recs)
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(text.encode())
    else:
        path.write_text(text)
    return str(path)


def assert_same_store(t, j, k, seq=None):
    assert t.counts_dict() == j.counts_dict()
    np.testing.assert_array_equal(t.total_added, np.asarray(j.total_added))
    assert t.n_unique == j.n_unique
    np.testing.assert_array_equal(api.kmer_spectrum(t, 40),
                                  japi.kmer_spectrum(j, 40))
    if seq is not None:
        got = api.seq_kmer_depth(t, seq, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      japi.seq_kmer_depth(j, seq, k))


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    recs = make_reads(1)
    fa = d / "c.fa"  # FASTA: every record goes through the encoder rows
    fa.write_text("".join(f">{n}\n{s[:30]}\n{s[30:]}\n"
                          for n, s, _q in make_reads(3, n=40)))
    return {"a": write_fastq(d / "a.fq", recs),
            "b": write_fastq(d / "b.fq.gz", make_reads(2, n=90), gz=True),
            "c": str(fa),
            "probe": recs[3][1] + "N" + recs[7][1].upper() + "nn"
            + recs[8][1]}


@pytest.mark.parametrize("exact_ll", [True, False, "hybrid"])
@pytest.mark.parametrize("k", [15, 32])
def test_flagship_matches_jax(fq, k, exact_ll):
    j = japi.count_kmers_fq_sh_rp(fq["a"], k=k, min_q=20, exact_ll=exact_ll)
    t = api.count_kmers_fq_sh_rp(fq["a"], k=k, min_q=20, exact_ll=exact_ll,
                                 device="cpu")
    assert t.n_unique > 50
    assert_same_store(t, j, k, fq["probe"])


@pytest.mark.parametrize("min_q", [0, 2, 30])
def test_hybrid_equals_exact_over_many_small_batches(fq, monkeypatch, min_q):
    """Small batches and frequent sweeps drive several tier merges and the
    backlog path; the answer does not depend on either."""
    k = 9
    want = api.count_kmers_fq_sh_rp(fq["a"], k=k, min_q=min_q,
                                    device="cpu")
    monkeypatch.setattr(counting, "BATCH_ROWS", 16)
    monkeypatch.setattr(counting, "_SWEEP_EVERY", 3)
    for mode in (True, "hybrid"):
        got = api.count_kmers_fq_sh_rp(fq["a"], k=k, min_q=min_q,
                                       exact_ll=mode, device="cpu")
        assert got.timings["tier_merges"] >= 3 or min_q == 30
        assert got.counts_dict() == want.counts_dict()
        np.testing.assert_array_equal(got.total_added, want.total_added)
    j = japi.count_kmers_fq_sh_rp(fq["a"], k=k, min_q=min_q,
                                  exact_ll="hybrid")
    assert_same_store(want, j, k)


@pytest.mark.parametrize("fsm", ["exact", "fast", "hybrid"])
def test_mixed_batch_with_and_without_qualities(fsm):
    """One batch whose rows partly lack qualities: those go through the
    encoder, the others through the FSM, into one run."""
    import jax.numpy as jnp

    from kmer_hasher_tpu import counting as jcounting
    from kmer_hasher_tpu.index.count_store import CountStore as JaxStore
    from kmer_hasher_tpu.qll import Q_TO_LL

    k = 11
    recs = make_reads(5, n=64, k=k)
    # columns padded to a multiple of 64, as the JAX package's batches are
    L = -(-max(len(r[1]) for r in recs) // 64) * 64
    seq = np.full((64, L), ord("N"), np.uint8)
    qual = np.zeros((64, L), np.uint8)
    lengths = np.zeros(64, np.int32)
    for i, (_n, s, q) in enumerate(recs):
        seq[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
        qual[i, :len(s)] = np.frombuffer(q.encode(), np.uint8)
        lengths[i] = len(s)
    has_qual = np.arange(64) % 3 != 1
    qual[~has_qual] = 0
    min_ll_f = float(Q_TO_LL[33 + 20])
    j = JaxStore(k, counts_n=2)
    r = jcounting._fused_rp_batch(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
        jnp.asarray(has_qual), k, 2, 1, min_ll_f, fsm, True,
        keyonly=j.keyonly_runs, min_q_char=53,
        n_win=jcounting.win_bucket(L, k))
    j.add_run(r[0], r[1], r[2], r[3], source=1)
    flagged = np.asarray(r[4])
    t = api.CountStore(k, counts_n=2, device="cpu")
    tr = counting._fused_rp_batch(
        *(torch.from_numpy(a) for a in (seq, qual, lengths, has_qual)), k,
        2, 1, min_ll_f, fsm, True, min_q_char=53,
        n_win=counting.win_bucket(L, k))
    t.add_run(tr[0], tr[1], tr[2], source=1)
    flags, n_flag = tr[3], tr[4]
    assert int(flags.sum()) == int(n_flag)
    assert not bool(flags[torch.from_numpy(~has_qual)].any())
    if not flagged.any() and not int(n_flag):
        assert_same_store(t, j, k)
    # either way the port's batch is the sum of its two kinds of rows
    parts = api.CountStore(k, counts_n=2, device="cpu")
    for rows in (has_qual, ~has_qual):
        counting.count_batches(
            parts, [(seq[rows], qual[rows], lengths[rows], has_qual[rows])],
            k, source=1, exact_ll={"exact": True, "fast": False}.get(
                fsm, "hybrid"))
    if fsm != "hybrid":
        assert t.counts_dict() == parts.counts_dict()
    else:  # the loop re-counts what the batch function left out
        whole = api.CountStore(k, counts_n=2, device="cpu")
        counting.count_batches(whole, [(seq, qual, lengths, has_qual)], k,
                               source=1, exact_ll="hybrid")
        assert whole.counts_dict() == parts.counts_dict()


def test_sweep_recounts_exactly_the_flagged_reads():
    """The backlog sweep with injected flags (real ones are rare): it adds
    exactly the flagged reads' exact-mode k-mers, whatever the batch."""
    k, min_ll_f = 11, float(counting.Q_TO_LL[33 + 20])
    recs = make_reads(9, n=80, k=k)
    L = max(len(r[1]) for r in recs)
    seq = np.full((80, L), ord("N"), np.uint8)
    qual = np.zeros((80, L), np.uint8)
    for i, (_n, s, q) in enumerate(recs):
        seq[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
        qual[i, :len(s)] = np.frombuffer(q.encode(), np.uint8)
    lengths = np.array([len(r[1]) for r in recs], np.int32)
    seq, qual, lengths = (torch.from_numpy(a) for a in (seq, qual, lengths))
    n_win = counting.win_bucket(L, k)
    for rows in ([3, 40, 79], list(range(0, 80, 2)), []):
        flags = torch.zeros(80, dtype=torch.bool)
        flags[rows] = True
        got = api.CountStore(k, device="cpu")
        backlog = [(seq, qual, lengths, flags, n_win, flags.sum())] * 2
        assert counting._sweep_backlog(got, backlog, k, 0,
                                       min_ll_f) == 2 * len(rows)
        assert backlog == []
        want = api.CountStore(k, device="cpu")
        for _ in range(2):
            counting.count_batches(
                want, [(seq[rows], qual[rows], lengths[rows],
                        torch.ones(len(rows), dtype=torch.bool))], k)
        assert got.counts_dict() == want.counts_dict()
        np.testing.assert_array_equal(got.total_added, want.total_added)


def test_file_list_and_two_sources(fq):
    k = 15
    j = japi.count_kmers_fq_sh_rp([fq["a"], fq["c"]], k=k, source_n=2,
                                  exact_ll="hybrid")
    j = japi.count_kmers_fq_sh_rp(fq["b"], k=k, source_n=2, source=1,
                                  store=j, exact_ll="hybrid")
    t = api.count_kmers_fq_sh_rp([fq["a"], fq["c"]], k=k, source_n=2,
                                 exact_ll="hybrid", device="cpu")
    t = api.count_kmers_fq_sh_rp(fq["b"], k=k, source_n=2, source=1,
                                 store=t, exact_ll="hybrid")
    assert_same_store(t, j, k, fq["probe"])
    assert (np.asarray(t.total_added) > 0).all()
    comb, inner, smin = [1, 2, 3, 3], [1, 1, 1, 0], [1, 2]
    np.testing.assert_array_equal(
        api.kmer_spectrum_n(t, 12, comb, inner, smin),
        japi.kmer_spectrum_n(j, 12, comb, inner, smin))


def test_skip_max_and_checkpoint_resume(fq, tmp_path, monkeypatch):
    k = 15
    full = japi.count_kmers_fq_sh_rp(fq["a"], k=k)
    leg = japi.count_kmers_fq_sh_rp(fq["a"], k=k, skip_reads=30,
                                    max_reads=50)
    t_leg = api.count_kmers_fq_sh_rp(fq["a"], k=k, skip_reads=30,
                                     max_reads=50, device="cpu")
    assert_same_store(t_leg, leg, k)
    # first leg with periodic checkpoints, then resume from the cursor
    monkeypatch.setattr(counting, "BATCH_ROWS", 20)
    ck = tmp_path / "ck.npz"
    api.count_kmers_fq_sh_rp(fq["a"], k=k, max_reads=70,
                             checkpoint_every=40, checkpoint_path=str(ck),
                             device="cpu")
    prog = tckpt.load_progress(ck)
    assert prog == {"path": fq["a"], "reads_done": 70, "done": False}
    assert jckpt.load_progress(ck) == prog  # the JAX package reads it too
    st = tckpt.load_count_store(ck, device="cpu")
    st = api.count_kmers_fq_sh_rp(fq["a"], k=k, store=st,
                                  skip_reads=prog["reads_done"],
                                  checkpoint_every=1000,
                                  checkpoint_path=str(ck))
    assert tckpt.load_progress(ck)["done"] is True
    assert_same_store(st, full, k, fq["probe"])
    assert_same_store(tckpt.load_count_store(ck, device="cpu"), full, k)


@pytest.mark.parametrize("k", [5, 21, 32])
def test_count_kmers_matches_jax(k):
    rng = np.random.default_rng(k)
    seqs = ["".join(rng.choice(list("ACGTacgtN"), size=int(n),
                               p=[.2, .2, .2, .2, .04, .04, .04, .04, .04]))
            for n in rng.integers(1, 120, size=12)]
    seqs.append("G" * 40)  # real all-G k-mers
    seqs.append("ACGT" * 3 + "N" + "ACGTA" * 7)  # a trailing exactly-k run
    j = japi.count_kmers(seqs, k, source=1, source_n=2)
    j = japi.count_kmers(seqs[:5], k, source=0, source_n=2, store=j)
    t = api.count_kmers(seqs, k, source=1, source_n=2, device="cpu")
    t = api.count_kmers(seqs[:5], k, source=0, source_n=2, store=t)
    assert t.mode == "khash"
    assert_same_store(t, j, k)


@pytest.mark.parametrize("k", [15, 32])
def test_depth_c_after_the_flagship_matches_jax(fq, k):
    """``semantics="c"`` on a store the flagship filled: the one-column
    shift, stale registers across the probe's N gaps, the tail."""
    j = japi.count_kmers_fq_sh_rp(fq["a"], k=k, min_q=20, source_n=2,
                                  source=1)
    t = api.count_kmers_fq_sh_rp(fq["a"], k=k, min_q=20, source_n=2,
                                 source=1, device="cpu")
    reads = sorted((r[1].upper() for r in make_reads(1) if "N" not in r[1]),
                   key=len)[-3:]  # the longest N-free reads
    probes = [fq["probe"], reads[0][:k] + "N" + reads[0] + "n" + reads[1],
              reads[2] + "NN" + reads[2][:k - 1]]
    seen = 0
    for q in probes:
        got = api.seq_kmer_depth(t, q, k, semantics="c")
        assert got.dtype == torch.int32 and got.shape == (2, len(q))
        np.testing.assert_array_equal(
            got.numpy(), japi.seq_kmer_depth(j, q, k, semantics="c"))
        seen += int((got > 0).sum())
    assert seen > 0
    intent = api.seq_kmer_depth(t, probes[0], k)
    assert not torch.equal(intent, api.seq_kmer_depth(t, probes[0], k,
                                                      semantics="c"))


def test_depth_is_na_over_n_and_short_sequences(fq):
    k = 15
    t = api.count_kmers_fq_sh_rp(fq["a"], k=k, device="cpu")
    d = api.seq_kmer_depth(t, "ACGTN" * 8, k)
    assert d.shape == (1, 40) and bool((d == -(2 ** 31)).all())
    assert api.seq_kmer_depth(t, "ACG", k).tolist() == [[-(2 ** 31)] * 3]
    with pytest.raises(ValueError):
        api.seq_kmer_depth(t, "ACGT" * 10, k + 1)
    with pytest.raises(ValueError):
        api.seq_kmer_depth(t, "ACGT" * 10, k, semantics="reference")
    # the exact-C track: NA over all-N input too, and n < k
    for semantics in ("intent", "c"):
        assert api.seq_kmer_depth(t, "ACG", k, semantics=semantics).tolist() \
            == [[-(2 ** 31)] * 3]


def test_argument_checks(fq):
    kw = dict(device="cpu")
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq["a"], k=33, **kw)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq["a"], k=15, source_n=5, **kw)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq["a"], k=15, source=1, **kw)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq["a"], k=15, checkpoint_every=5, **kw)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp([fq["a"], fq["b"]], k=15, max_reads=5, **kw)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp([], k=15, **kw)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq["a"], k=15, exact_ll="fast", **kw)
    st = api.CountStore(15, device="cpu")
    with pytest.raises(ValueError):  # mesh= fills a sharded store only
        api.count_kmers_fq_sh_rp(fq["a"], k=15, store=st,
                                 mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq["a"], k=9, store=st)
    assert counting.win_bucket(151, 21) == 140
    assert counting.derive_prefix_suffix_bits(21, 20) == (20, 22)
    assert counting.derive_prefix_suffix_bits(32, 20) == (32, 32)


def test_progress_meter_reports(fq, monkeypatch):
    from kmer_hasher_tpu_torch.utils import metrics

    monkeypatch.setattr(counting, "BATCH_ROWS", 40)
    seen = []
    m = metrics.ProgressMeter(name="t", report_every=50, sink=seen.append)
    st = api.CountStore(15, device="cpu")
    counting.count_batches(
        st, counting._iter_file_batches(fq["a"], None), 15, meter=m)
    assert [r["total"] for r in seen] == [80, 150]
    assert seen[-1]["distinct_kmers"] == st.n_unique
    top = metrics.most_common_kmer(st)
    col = st.cnt[:, 0]
    assert top["count"] == int(col.max()) and len(top["kmer"]) == 15
    assert metrics.most_common_kmer(api.CountStore(5, device="cpu")) == {
        "kmer": None, "count": 0}
    assert metrics.decode_kmer(0b00011011, 4) == "ACTG"
