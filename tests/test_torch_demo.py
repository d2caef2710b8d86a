"""The port's twin of ``examples/demo.py``
(``python -m kmer_hasher_tpu_torch.examples.demo --data DIR --device cpu``)
on a seeded directory of the three files the JAX script reads: a
32,000-base ``test.fa`` (the query is ``seq[30000:31000]``), 300 reads of
150 bases drawn from it (20 of them over an ACTGG repeat in it) with a
few substitutions at Q30-Q40 in
``test.fastq.gz`` (at Q2-Q41 with ``min_q=20`` no 21-mer would pass), and
40 ``ACTGG`` repeat reads in ``repeat_40.fq``. Every figure the twin prints
is held against the JAX API called in this process on the same files (the
JAX script itself, run in a subprocess, takes minutes of compiles)."""
import contextlib
import gzip
import io
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

import kmer_hasher_tpu  # noqa: F401  (x64, the JAX package's setting)
from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu.parallel import ShardedKmerIndex as JShardedKmerIndex
from kmer_hasher_tpu.parallel import make_mesh as jmake_mesh
from kmer_hasher_tpu.utils.metrics import most_common_kmer
from kmer_hasher_tpu_torch.examples import demo

SEQ_LEN, READS, READ_LEN, REPEATS = 32_000, 300, 150, 40
REPEAT_AT = 25_000
NA = -(2 ** 31)


def write_data(d: Path) -> str:
    """The three files, from one seed; returns the sequence."""
    rng = np.random.default_rng(20261017)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, SEQ_LEN)].copy()
    seq[12_000:12_600] = seq[3_000:3_600]  # a repeat for the dot plot
    seq[20_000:20_040] = ord("G")
    # an ACTGG repeat that reads cover, so that 21-mers lie in both sources
    seq[REPEAT_AT:REPEAT_AT + 400] = np.frombuffer(b"ACTGG" * 80, np.uint8)
    text = seq.tobytes().decode()
    fa = [">SYN_1 seeded"] + [text[i:i + 80] for i in range(0, SEQ_LEN, 80)]
    (d / "test.fa").write_text("\n".join(fa) + "\n")
    recs = []
    for i in range(READS):
        a = int(rng.integers(0, SEQ_LEN - READ_LEN)) if i >= 20 else (
            REPEAT_AT + 10 * i)
        r = seq[a:a + READ_LEN].copy()
        sub = rng.random(READ_LEN) < 0.005
        r[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
        q = rng.integers(33 + 30, 33 + 41, READ_LEN).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), q.tobytes()))
    (d / "test.fastq.gz").write_bytes(gzip.compress(b"".join(recs)))
    rep = []
    for i in range(REPEATS):
        s = (b"ACTGG" * 50)[i % 5: i % 5 + 200]
        q = rng.integers(33 + 30, 33 + 41, len(s)).astype(np.uint8)
        rep.append(b"@rep%d\n%s\n+\n%s\n" % (i, s, q.tobytes()))
    (d / "repeat_40.fq").write_bytes(b"".join(rep))
    return text


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the twin's figures and printed lines, the data directory, the
    sequence, what was left in the temporary directory it was given)."""
    d = tmp_path_factory.mktemp("demo_data")
    seq = write_data(d)
    scratch = tmp_path_factory.mktemp("demo_tmp")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(buf):
        mp.setattr(tempfile, "tempdir", str(scratch))
        rec = demo.main(["--data", str(d), "--device", "cpu"])
    return rec, buf.getvalue(), d, seq, os.listdir(scratch)


def test_every_section_prints_and_ends_complete(run):
    rec, out, _d, _seq, _left = run
    lines = out.splitlines()
    assert lines[0] == "cpu, host clock (not a device time)"
    assert lines[1] == "backend: cpu, devices: 1"
    for text in ("[SYN_1] 32000 bp, k=8", "most frequent:", "streamed",
                 "seq.kmer.pos:", "kmer.pairs:", "count.kmers:",
                 "count.kmers.fq.sh.rp:", "kmer.spec.sh.n:",
                 "seq.kmer.depth:", "semantics='c'", "make_kmer_hash_many:",
                 "checkpoint round-trip OK", "sharded index over 8 shards"):
        assert any(text in ln for ln in lines), text
    assert lines[-1] == "demo complete"
    assert rec["distinct"] > 0 and rec["in_both"] > 0  # Q30+: reads count


def test_index_sections_equal_the_jax_api(run):
    """The index and its tables, the streamed pairs, the query, kmer.pairs
    and the batched build."""
    rec, _out, _d, seq, _left = run
    idx = japi.make_kmer_hash(seq, k=8)
    t = japi.kmer_pos(idx, opt_flag=1 | 2 | 8)
    assert (rec["n_kmers"], rec["positions"], rec["pairs"]) == (
        idx.n_kmers, t["pos"].shape[0], idx.total_pairs)
    assert rec["most_frequent"] == t["kmer"][int(np.argmax(t["count"]))]
    assert rec["most_frequent_count"] == int(np.max(t["count"]))
    assert rec["streamed"] == sum(
        len(c) for c in idx.iter_pair_chunks(capacity=1 << 21))
    idx16 = japi.make_kmer_hash(seq, k=16)
    m = japi.seq_kmer_pos(idx16, seq[30000:31000], k=16)
    assert rec["query_hits"] == m.shape[0] > 0
    p = japi.kmer_pairs(japi.make_kmer_hash(seq[:5000], 12),
                        japi.make_kmer_hash(seq[2500:7500], 12))
    assert rec["kmer_pairs"] == p.shape[0] > 0
    idxs = japi.make_kmer_hash_many([seq[i:i + 3000]
                                     for i in range(0, 12000, 3000)], k=12)
    assert (rec["many"], rec["many_distinct"]) == (
        len(idxs), sum(ix.n_kmers for ix in idxs))
    s = JShardedKmerIndex(seq, k=16, mesh=jmake_mesh(8))
    assert rec["sharded_kmers"] == s.total_kmers == idx16.n_valid


def test_counting_sections_equal_the_jax_api(run):
    """count.kmers, the flagship counting of both files into two sources,
    its spectrum, most common k-mer and kmer.spec.sh.n, and both depth
    semantics on read 0."""
    rec, _out, d, seq, _left = run
    st = japi.count_kmers([seq[:10000], seq[10000:20000]], k=11, source=0,
                          source_n=2)
    st = japi.count_kmers([seq[20000:30000]], k=11, source=1, source_n=2,
                          store=st)
    assert rec["count_kmers_distinct"] == st.n_unique
    store = japi.count_kmers_fq_sh_rp(str(d / "test.fastq.gz"), k=21,
                                      min_q=20, source_n=2, source=0)
    store = japi.count_kmers_fq_sh_rp(str(d / "repeat_40.fq"), k=21,
                                      min_q=20, source_n=2, source=1,
                                      store=store)
    spec = japi.kmer_spectrum(store, max_count=100)
    mc = most_common_kmer(store)
    assert (rec["distinct"], rec["singletons"]) == (store.n_unique,
                                                    int(spec[1]))
    assert (rec["most_common"], rec["most_common_count"]) == (mc["kmer"],
                                                              mc["count"])
    both = japi.kmer_spectrum_n(store, 50, comb=[3], comb_inner=[1],
                                source_min=[1, 1])
    assert rec["in_both"] == int(np.asarray(both)[0].sum())
    with gzip.open(d / "test.fastq.gz", "rt") as f:
        f.readline()
        read0 = f.readline().strip()
    row = np.asarray(japi.seq_kmer_depth(store, read0, k=21))[0]
    assert rec["depth_valid"] == int((row != NA).sum())
    assert rec["depth_max"] == int(row[row != NA].max())
    row_c = np.asarray(japi.seq_kmer_depth(store, read0, k=21,
                                           semantics="c"))[0]
    assert rec["depth_c_written"] == int((row_c != NA).sum())


def test_no_file_left_behind(run):
    """The checkpoint round trip writes into a temporary directory of its
    own and removes it (the JAX script writes a fixed path), and nothing
    is written beside the data."""
    _rec, _out, d, _seq, left = run
    assert left == []
    assert sorted(os.listdir(d)) == ["repeat_40.fq", "test.fa",
                                     "test.fastq.gz"]
