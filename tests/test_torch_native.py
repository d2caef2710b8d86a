"""The port's native FASTA/FASTQ reader (``io/native.py`` over its own copy
of the C++ parser) against the JAX package's native reader and both
pure-Python readers, on generated files; the byte-range forms; and the
two routes of ``counting._iter_file_batches`` (native, Python) against one
another and the JAX package's store.
Everything compared is bytes or integers: no tolerance.

Tests that need a native library take a fixture that skips, visibly, where
g++ or zlib is absent."""
import gzip
import threading

import numpy as np
import pytest

from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu.io import fastx as jfx
from kmer_hasher_tpu.io import native as jnative_mod
from kmer_hasher_tpu_torch import api as tapi
from kmer_hasher_tpu_torch import counting as tcount
from kmer_hasher_tpu_torch.io import fastx as tfx
from kmer_hasher_tpu_torch.io import native as tnative_mod

K = 11


@pytest.fixture
def tnative():
    if not tnative_mod.available():
        pytest.skip("the port's native parser is unavailable here: "
                    + (tnative_mod.build_error() or "KMH_NATIVE_IO=0"))
    return tnative_mod


@pytest.fixture
def jnative():
    if not jnative_mod.available():
        pytest.skip("the JAX package's native parser is unavailable here")
    return jnative_mod


def _reads(rng, n, quals):
    """n (name, seq, qual) records: lengths 1..150 with some <= K, N runs,
    lower case; ``quals``: "binned" (4 values), "wide" (> 16 distinct,
    span < 63), "huge" (span > 62)."""
    out = []
    for i in range(n):
        L = int(rng.choice([1, 2, K - 1, K, K + 1, 40, 97, 150]))
        if i % 3 == 0:
            L = int(rng.integers(20, 151))
        s = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=L)
        if L > 30 and i % 4 == 0:
            s[10: 10 + int(rng.integers(1, 6))] = ord("N")
        if quals == "binned":
            q = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=L,
                           p=(0.85, 0.09, 0.03, 0.03))
        elif quals == "wide":
            q = (33 + rng.integers(2, 42, size=L)).astype(np.uint8)
            q[rng.random(L) < 0.8] = ord("I")
        else:
            q = (33 + rng.integers(0, 93, size=L)).astype(np.uint8)
            q[rng.random(L) < 0.8] = ord("I")
        out.append((f"r{i}", s.tobytes(), q.tobytes()))
    return out


def _fastq(recs) -> bytes:
    return b"".join(b"@" + n.encode() + b" c\n" + s + b"\n+\n" + q + b"\n"
                    for n, s, q in recs)


def _fasta(recs, width=60) -> bytes:
    out = []
    for n, s, _q in recs:
        out.append(b">" + n.encode() + b" descr\n")
        out += [s[i: i + width] + b"\n" for i in range(0, len(s), width)]
    return b"".join(out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fx")
    rng = np.random.default_rng(77)
    paths = {}
    for name, data in (
            ("binned.fq", _fastq(_reads(rng, 300, "binned"))),
            ("wide.fq", _fastq(_reads(rng, 300, "wide"))),
            ("huge.fq", _fastq(_reads(rng, 120, "huge"))),
            ("noN.fq", _fastq([(n, s.upper().replace(b"N", b"A"), q)
                               for n, s, q in _reads(rng, 90, "binned")])),
            ("multi.fa", _fasta(_reads(rng, 40, "binned")))):
        (d / name).write_bytes(data)
        paths[name] = str(d / name)
        if name in ("wide.fq", "multi.fa"):
            (d / (name + ".gz")).write_bytes(gzip.compress(data))
            paths[name + ".gz"] = str(d / (name + ".gz"))
    return paths


NAMES = ["binned.fq", "wide.fq", "huge.fq", "noN.fq", "multi.fa",
         "wide.fq.gz", "multi.fa.gz"]


@pytest.mark.parametrize("name", NAMES)
def test_records_equal_all_four_readers(files, name, tnative, jnative):
    p = files[name]
    want = jfx.read_fastx_py(p)
    assert len(want) >= 40
    assert tnative.read_fastx(p) == want
    assert jnative.read_fastx(p) == want
    assert tfx.read_fastx(p) == want
    assert tnative.read_fastx(p, 7) == want[:7]
    assert tfx.is_gzip(p) == jfx.is_gzip(p) == name.endswith(".gz")


@pytest.mark.parametrize("name", ["wide.fq", "multi.fa", "wide.fq.gz"])
def test_raw_buffers_equal_the_jax_reader(files, name, tnative, jnative):
    p = files[name]
    for got, want in zip(tnative.read_fastx_raw(p), jnative.read_fastx_raw(p)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = list(tnative.iter_fastx_raw(p, 64, max_records=150))
    want = list(jnative.iter_fastx_raw(p, 64, max_records=150))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    with pytest.raises(FileNotFoundError):
        tnative.read_fastx(p + ".missing")
    with pytest.raises(FileNotFoundError):
        next(tnative.iter_fastx_padded(p + ".missing"))


def _same_reads(got, want_seq, want_qual):
    """The planes hold the same reads: qualities byte-exact, the sequence
    equal in what the device path reads of it (2-bit code where the base is
    no N, and the N flag), pads 0 and 'N'."""
    seq, qual, lengths, _ = got
    B, L = seq.shape
    assert L % 8 == 0 and L - 8 < max(1, int(lengths.max())) <= L
    cols = np.arange(L) < lengths[:, None]
    assert np.array_equal(qual, np.where(cols, want_qual[:B, :L], 0))
    is_n = (want_seq[:B, :L] | 0x20) == ord("n")
    got_n = (seq | 0x20) == ord("n")
    assert np.array_equal(got_n[cols], is_n[cols])
    assert got_n[~cols].all()
    live = cols & ~is_n
    assert np.array_equal(((seq >> 1) & 3)[live],
                          ((want_seq[:B, :L] >> 1) & 3)[live])


@pytest.mark.parametrize("name", ["binned.fq", "wide.fq", "huge.fq",
                                  "noN.fq", "multi.fa", "wide.fq.gz"])
def test_padded_batches(files, name, tnative, jnative):
    """Padded batches equal the JAX reader's inside the port's own shape
    (rows = reads, columns = the multiple of 8 that holds the longest)."""
    p = files[name]
    rows = 64
    padded = list(tnative.iter_fastx_padded(p, rows))
    theirs = list(jnative.iter_fastx_padded(p, rows))
    n = len(jfx.read_fastx_py(p))
    assert len(padded) == len(theirs) == -(-n // rows)
    for pd, (jseq, jqual, jlen, jhq) in zip(padded, theirs):
        seq, qual, lengths, has_qual = pd
        B = seq.shape[0]
        assert B == min(rows, n) or B == n % rows
        assert seq.dtype == qual.dtype == np.uint8 and seq.shape == qual.shape
        assert lengths.dtype == np.int32 and has_qual.dtype == bool
        assert np.array_equal(lengths, jlen[:B]) and (jlen[B:] == 0).all()
        assert np.array_equal(has_qual, jhq[:B])
        L = seq.shape[1]
        assert np.array_equal(seq, jseq[:B, :L])
        assert np.array_equal(qual, jqual[:B, :L])
        assert (jseq[:B, L:] == ord("N")).all()
        _same_reads(pd, jseq, jqual)


def test_skip_and_max_records(files, tnative):
    p = files["wide.fq"]
    it = tnative.iter_fastx_padded
    whole = np.concatenate([b[2] for b in it(p, 64)])
    for skip, limit in ((0, 10), (5, 64), (64, 70), (130, None), (299, 5),
                        (300, None), (1000, 3)):
        got = [b[2] for b in it(p, 64, limit, skip)]
        got = np.concatenate(got) if got else np.zeros(0, np.int32)
        end = None if limit is None else skip + limit
        assert np.array_equal(got, whole[skip:end]), (skip, limit)
    with pytest.raises(ValueError):
        next(it(p, 64, None, 3, byte_range=(0, 100)))


def test_truncated_last_record(tmp_path, tnative, jnative):
    """A FASTQ whose last record lost its quality line: both native readers
    refuse the file, both Python readers give the record without
    qualities."""
    p = tmp_path / "cut.fq"
    p.write_text("@a\nACGTACGT\n+\nIIIIIIII\n@b\nACGTT\n+\nII")
    for nat in (tnative, jnative):
        with pytest.raises(ValueError):
            nat.read_fastx(str(p))
    with pytest.raises(ValueError):
        list(tnative.iter_fastx_padded(str(p)))
    want = [("a", b"ACGTACGT", b"IIIIIIII"), ("b", b"ACGTT", None)]
    assert tfx.read_fastx(str(p)) == jfx.read_fastx_py(str(p)) == want
    junk = tmp_path / "junk.txt"
    junk.write_text("hello\n")
    with pytest.raises(ValueError):
        tnative.read_fastx(str(junk))


@pytest.mark.parametrize("n_ranges", [1, 2, 3, 7])
@pytest.mark.parametrize("name", ["binned.fq", "wide.fq", "multi.fa"])
def test_byte_ranges_tile_the_file(files, name, n_ranges, tnative):
    """Consecutive byte ranges give every record exactly once, through the
    native range opener and the Python one; the resolved boundaries are
    contiguous and equal in both, and equal to the JAX package's."""
    import os

    p = files[name]
    size = os.path.getsize(p)
    whole = tfx.read_fastx(p)
    assert tfx.is_fourline_fastq(p) and jfx.is_fourline_fastq(p)
    lens_n, recs_py, infos = [], [], []
    for i in range(n_ranges):
        lo, hi = size * i // n_ranges, size * (i + 1) // n_ranges
        info_n, info_p, info_j = {}, {}, {}
        for b in tnative.iter_fastx_padded(p, 50, byte_range=(lo, hi),
                                           range_info=info_n):
            lens_n.append(b[2])
        for recs in tfx.iter_fastx_range(p, lo, hi, 50, range_info=info_p):
            recs_py += recs
        got_j = [r for recs in jfx.iter_fastx_range(p, lo, hi, 50,
                                                    range_info=info_j)
                 for r in recs]
        assert info_p == info_j
        assert tfx.find_record_boundary(p, lo, hi) == jfx.find_record_boundary(
            p, lo, hi)
        assert recs_py[len(recs_py) - len(got_j):] == got_j
        if info_n["start"] != info_n["end"] or info_p["start"] != info_p["end"]:
            assert info_n == info_p, (i, info_n, info_p)
        infos.append(info_n)
    assert recs_py == whole
    assert np.array_equal(np.concatenate(lens_n),
                          np.array([len(r[1]) for r in whole], np.int32))
    owned = [f for f in infos if f["start"] != f["end"]]
    assert owned[0]["start"] == 0 and owned[-1]["end"] == size
    for a, b in zip(owned, owned[1:]):
        assert a["end"] == b["start"]


def test_fourline_gate(tmp_path):
    ml = tmp_path / "ml.fq"
    ml.write_text("@r1\nACGT\nACGT\n+\nIIII\nIIII\n@r2\nTT\n+\nJJ\n")
    assert not tfx.is_fourline_fastq(str(ml))
    assert not jfx.is_fourline_fastq(str(ml))
    empty = tmp_path / "e.fq"
    empty.write_text("")
    assert tfx.is_fourline_fastq(str(empty))


def _fill(rng, L):
    return "".join(rng.choice(list("ACGT"), size=L))


@pytest.fixture(scope="module")
def count_fq(tmp_path_factory):
    """A FASTQ with real coverage (reads of one 600-base genome, mostly
    high qualities, > 16 distinct, some N) and a FASTA record behind it."""
    rng = np.random.default_rng(9)
    g = _fill(rng, 600)
    lines = []
    for i in range(260):
        a = int(rng.integers(0, 520))
        L = int(rng.integers(K - 2, 81))
        s = list(g[a: a + L])
        if i % 9 == 0 and len(s) > 20:
            s[7] = "N"
        q = rng.integers(25, 42, size=len(s))
        q[rng.random(len(s)) < 0.05] = rng.integers(2, 15)
        lines.append(f"@r{i}\n{''.join(s)}\n+\n"
                     f"{''.join(chr(33 + int(x)) for x in q)}\n")
    p = tmp_path_factory.mktemp("cnt") / "reads.fq"
    p.write_text("".join(lines))
    return str(p)


ROUTES = {"native": {}, "python": {"KMH_NATIVE_IO": "0"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_gives_the_same_batches_and_store(
        count_fq, route, tnative, monkeypatch):
    """The routes of _iter_file_batches, chosen through the environment at
    call time: the same reads in every batch, the reader's name where the
    caller can see it, and one store, the JAX package's."""
    base = list(tcount._iter_file_batches(count_fq, None, batch_rows=100))
    for key, val in ROUTES[route].items():
        monkeypatch.setenv(key, val)
    info = {}
    got = list(tcount._iter_file_batches(count_fq, 150, skip=30,
                                         batch_rows=100, info=info))
    assert info["reader"] == route
    assert info["parse_s"] > 0 and info["wait_s"] >= 0
    # batches stay aligned to the file's: the skip cuts into the first
    assert [len(b[2]) for b in got] == [70, 80]
    whole_seq = np.concatenate([np.pad(b[0], ((0, 0), (0, 88 - b[0].shape[1])),
                                       constant_values=ord("N"))
                                for b in base])
    whole_qual = np.concatenate([np.pad(b[1], ((0, 0), (0, 88 - b[1].shape[1])))
                                 for b in base])
    at = 30
    for b in got:
        _same_reads(b, whole_seq[at:], whole_qual[at:])
        at += len(b[2])
    monkeypatch.setenv("KMH_BATCH_ROWS", "64")
    st = tapi.count_kmers_fq_sh_rp(count_fq, k=K, min_q=20,
                                   exact_ll="hybrid", device="cpu")
    assert st.timings["reader"] == info["reader"]
    by_arg = tapi.count_kmers_fq_sh_rp(count_fq, k=K, min_q=20,
                                       exact_ll="hybrid", batch_rows=37,
                                       device="cpu")
    assert by_arg.counts_dict() == st.counts_dict()
    assert st.timings["file_reads"] == 260 and st.timings["parse_s"] > 0
    ref = japi.count_kmers_fq_sh_rp(count_fq, k=K, min_q=20)
    assert st.n_unique > 300
    assert st.counts_dict() == ref.counts_dict()
    assert np.array_equal(st.total_added, np.asarray(ref.total_added))
    for entry in ("count_kmers_fq", "count_kmers_fq_sh"):
        th = getattr(tapi, entry)(count_fq, k=K, min_q=20, device="cpu")
        tj = getattr(japi, entry)(count_fq, k=K, min_q=20)
        assert th.timings["reader"] == info["reader"]
        assert np.array_equal(tapi.kmer_spectrum(th, 50),
                              japi.kmer_spectrum(tj, 50))


def test_a_failed_build_is_kept_not_hidden(tmp_path, monkeypatch):
    """Where the parser does not build, available() is false, the
    compiler's message is kept, and the file entries say which reader
    ran."""
    bad = tmp_path / "fastx.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative_mod, "_SRC", bad)
    monkeypatch.setattr(tnative_mod, "_tried", False)
    monkeypatch.setattr(tnative_mod, "_lib", None)
    monkeypatch.setattr(tnative_mod, "_error", "")
    monkeypatch.setattr(tnative_mod, "BUILD_DIR", tmp_path / "build")
    assert not tnative_mod.available()
    assert tnative_mod.reader_name() == "python"
    msg = tnative_mod.build_error()
    assert "g++" in msg and ("error" in msg or "No such file" in msg)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative_mod.read_fastx(str(bad))
    fq = tmp_path / "r.fq"
    fq.write_text("@r\nACGTTGCAGGACGTTA\n+\nIIIIIIIIIIIIIIII\n")
    st = tapi.count_kmers_fq_sh_rp(str(fq), k=K, device="cpu")
    assert st.timings["reader"] == "python" and st.n_unique > 0


def test_the_producer_thread_overlaps_stops_and_reports():
    """_prefetch runs its iterator in one thread, ahead of the consumer;
    an error there is raised here; a consumer that stops early stops and
    joins the producer."""
    made = []

    def numbers(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise KeyError("parse error")
            made.append(i)
            yield i

    info = {}
    before = threading.active_count()
    assert list(tcount._prefetch(numbers(5), 2, info)) == [0, 1, 2, 3, 4]
    assert info["parse_s"] >= 0 and info["wait_s"] >= 0
    with pytest.raises(KeyError):
        list(tcount._prefetch(numbers(5, fail_at=2), 2, {}))
    made.clear()
    it = tcount._prefetch(numbers(100), 2, {})
    assert next(it) == 0
    it.close()
    assert len(made) <= 5  # at most the queue's depth ahead, then stopped
    assert threading.active_count() == before


def test_empty_reads_in_the_middle_and_last(tmp_path, tnative, jnative,
                                            monkeypatch):
    """A FASTQ with empty reads, one in the middle and one last: both of the
    port's readers (the range form too) give the records of the JAX
    package's native reader, each empty read with its empty quality line
    and the next header still a header (kseq reads at least one quality
    line, src/kseq.h:195-218); and both routes of _iter_file_batches give
    one store. The JAX package's pure-Python reader has the same fault the
    port's had — it takes the empty quality line for the next record's
    header — and is left as it is: it is the reference package's."""
    p = tmp_path / "empty.fq"
    body = (b"@r1\nACGTACGTACGTAC\n+\nIIIIIIIIIIIIII\n@r2\n\n+\n\n"
            b"@r3\nTTTTGGGGCCCCAAAATT\n+\nIIIIIIIIIIIIIIIIII\n@r4\n\n+\n\n")
    p.write_bytes(body)
    want = [("r1", b"ACGTACGTACGTAC", b"I" * 14), ("r2", b"", b""),
            ("r3", b"TTTTGGGGCCCCAAAATT", b"I" * 18), ("r4", b"", b"")]
    assert jnative.read_fastx(str(p)) == want
    assert tnative.read_fastx(str(p)) == want
    assert tfx.read_fastx(str(p)) == want
    assert [r for b in tfx.iter_fastx_range(str(p), 0, len(body))
            for r in b] == want
    assert jfx.read_fastx_py(str(p)) != want  # the JAX reader's fault
    stores = []
    for env in ({}, {"KMH_NATIVE_IO": "0"}):
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        info = {}
        batches = list(tcount._iter_file_batches(str(p), None, info=info))
        assert [b[2].tolist() for b in batches] == [[14, 0, 18, 0]]
        assert [b[3].tolist() for b in batches] == [[True] * 4]
        st = tapi.count_kmers_fq_sh_rp(str(p), k=5, min_q=20, device="cpu")
        assert st.timings["reader"] == info["reader"]
        stores.append(st)
    assert info["reader"] == "python"
    assert stores[0].counts_dict() == stores[1].counts_dict()
    assert stores[0].n_unique > 0
    assert np.array_equal(stores[0].total_added, stores[1].total_added)
