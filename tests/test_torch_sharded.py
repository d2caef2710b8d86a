"""The port's sharded count store against the JAX package's
``ShardedCountStore`` on the 8-device virtual CPU mesh (``conftest.py``),
shard table by shard table and bitwise; against the port's single store;
``owner_hash`` against the JAX function; ``count_kmers_fq_sh_rp(mesh=)``
and ``count --mesh`` against one store; per-shard spill; and sharded
checkpoints crossing the packages both ways.

The JAX store is run with its live-prefix run trimming on and, through its
module flag (``KMH_TRIM_RUNS=0``), off: the shard tables are the same."""
import json

import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (x64, the JAX package's setting)
from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu.index import count_store as jcs
from kmer_hasher_tpu.parallel import ShardedCountStore as JShardedCountStore
from kmer_hasher_tpu.parallel import make_mesh as jmake_mesh
from kmer_hasher_tpu.parallel.sharded import owner_hash as jowner_hash
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch import __main__ as tcli
from kmer_hasher_tpu_torch import api, counting
from kmer_hasher_tpu_torch.counting import win_bucket
from kmer_hasher_tpu_torch.ops import cuda_scan
from kmer_hasher_tpu_torch.parallel import (ShardedCountStore,
                                            make_hierarchical_mesh,
                                            make_mesh, owner_hash,
                                            owner_of_keys)
from kmer_hasher_tpu_torch.qll import Q_TO_LL
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

CPU = "cpu"
READ_LEN = 100


def read_batch(seed: int, rows: int = 256):
    """Host (seq, qual, lengths, has_qual) of ``rows`` reads: random bases
    with 1% N, lengths 40-100 padded with N, borderline-rich qualities (5%
    of bases at q0-q6, the rest q2-q40: at min_q 0 the f32 filter flags a
    few reads), and 5% of rows without qualities."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows,
                                                               READ_LEN))]
    seq = seq.copy()
    seq[rng.random(seq.shape) < 0.01] = ord("N")
    lengths = rng.integers(40, READ_LEN + 1, rows).astype(np.int32)
    qual = rng.integers(35, 74, (rows, READ_LEN)).astype(np.uint8)
    low = rng.random(qual.shape) < 0.1
    qual[low] = rng.integers(33, 40, int(low.sum())).astype(np.uint8)
    has_qual = rng.random(rows) >= 0.05
    pad = np.arange(READ_LEN)[None, :] >= lengths[:, None]
    seq[pad] = ord("N")
    qual[pad | ~has_qual[:, None]] = 0
    return seq, qual, lengths, has_qual


def jax_tables(st):
    """Per shard of a JAX store: (raw uint64 keys, uint32 counts) of its
    live rows."""
    n = np.asarray(st.n_unique)
    hi, lo, cnt = (np.asarray(a) for a in (st.u_hi, st.u_lo, st.cnt))
    raw = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return [(raw[d, : n[d]], cnt[d, : n[d]].astype(np.int64))
            for d in range(len(n))]


def port_tables(st):
    """The same for a port store, through its own checkpoint lanes."""
    st.flush()
    return [(((s.keys ^ -(2 ** 63)).numpy().view(np.uint64)),
             s.cnt.numpy()) for s in st.shards]


def assert_same_shards(a, b):
    assert len(a) == len(b)
    for (ka, ca), (kb, cb) in zip(a, b):
        assert np.array_equal(ka, kb)
        assert np.array_equal(ca, cb)


def assert_union_is(st, single):
    """The shard tables, merged, are the single store's table bitwise, and
    every shard holds only its own keys."""
    st.flush()
    single.flush()
    keys = torch.cat([s.keys for s in st.shards])
    cnt = torch.cat([s.cnt for s in st.shards])
    order = torch.sort(keys)
    assert torch.equal(order.values, single.keys)
    assert torch.equal(cnt[order.indices], single.cnt)
    for d, s in enumerate(st.shards):
        assert bool((owner_of_keys(s.keys, st.n_shards) == d).all())
    np.testing.assert_array_equal(st.total_added, single.total_added)
    np.testing.assert_array_equal(st.spectrum(300), single.spectrum(300))


@pytest.fixture
def trim(request, monkeypatch):
    monkeypatch.setattr(jcs, "_TRIM_RUNS", request.param)
    return request.param


CASES = [  # (shards, k, precision, sources, JAX trimming)
    (8, 32, "exact", 2, False),
    (2, 21, "hybrid", 1, True),
]


@pytest.mark.parametrize("d,k,precision,sources,trim", CASES,
                         indirect=["trim"])
def test_add_reads_equals_the_jax_store_shard_by_shard(d, k, precision,
                                                       sources, trim):
    min_q = 0
    min_ll = float(Q_TO_LL[33 + min_q])
    j = JShardedCountStore(k, jmake_mesh(d), counts_n=sources)
    t = ShardedCountStore(k, make_mesh(d, device=CPU), counts_n=sources)
    single = api.CountStore(k, counts_n=sources, device=CPU)
    flagged = 0
    for b in range(2):
        seq, qual, lengths, hq = read_batch(100 * k + b)
        src = b % sources
        n_win = win_bucket(lengths.max(), k)
        kw = dict(precision=precision, source=src,
                  with_noq=bool((~hq & (lengths > 0)).any()),
                  min_q_char=33 + min_q, n_win=n_win)
        j.add_reads(seq, qual, lengths, hq, min_ll, with_q=True, **kw)
        tens = [torch.from_numpy(a) for a in (seq, qual, lengths, hq)]
        t.add_reads(*tens, min_ll, **kw)
        counting.count_batches(single, [(seq, qual, lengths, hq)], k,
                               min_q=min_q, source=src,
                               exact_ll="hybrid" if precision == "hybrid"
                               else True)
        flagged += int(cuda_scan.scan(
            tens[0], tens[1], torch.where(tens[3], tens[2], 0), k, min_ll,
            precision="fast", return_flags=True,
            min_q_char=33 + min_q)[3].sum())
    if precision == "hybrid":
        assert flagged > 0  # the f64 re-count really ran
    assert_same_shards(port_tables(t), jax_tables(j))
    np.testing.assert_array_equal(t.n_unique, np.asarray(j.n_unique))
    np.testing.assert_array_equal(t.total_added, np.asarray(j.total_added))
    np.testing.assert_array_equal(t.spectrum(300), np.asarray(j.spectrum(300)))
    assert_union_is(t, single)
    q = torch.cat([s.keys for s in t.shards])[::7] ^ -(2 ** 63)
    q = torch.cat([q, torch.tensor([0, 12345], dtype=torch.int64)])
    qn = q.numpy().view(np.uint64)
    np.testing.assert_array_equal(
        t.lookup(q).numpy(),
        np.asarray(j.lookup((qn >> np.uint64(32)).astype(np.uint32),
                            qn.astype(np.uint32))))
    if sources == 2:
        args = (50, [1, 2, 3], [0, 1, 1], [1, 1])
        np.testing.assert_array_equal(t.spectrum_n(*args),
                                      np.asarray(j.spectrum_n(*args)))
    assert t.peek_n_unique() == int(np.asarray(j.n_unique).sum())


@pytest.mark.parametrize("d,trim", [(8, True), (2, False)],
                         indirect=["trim"])
def test_add_batch_k32_with_the_all_g_kmer(d, trim):
    """Raw 32-mers through ``add_batch``, the all-ones key (all-G, the JAX
    store's dead-row pattern) among them, two sources."""
    rng = np.random.default_rng(32 + d)
    j = JShardedCountStore(32, jmake_mesh(d), counts_n=2)
    t = ShardedCountStore(32, make_mesh(d, device=CPU), counts_n=2)
    pool = rng.integers(0, 2 ** 64, 300, np.uint64)
    pool[:3] = [2 ** 64 - 1, 0, 2 ** 63]
    for b in range(4):
        raw = pool[rng.integers(0, pool.size, d * 96)]
        raw[:2] = 2 ** 64 - 1
        valid = rng.random(raw.size) < 0.9
        hi = (raw >> np.uint64(32)).astype(np.uint32).reshape(d, -1)
        lo = raw.astype(np.uint32).reshape(d, -1)
        j.add_batch(hi, lo, valid.reshape(d, -1), source=b % 2)
        t.add_batch(torch.from_numpy(raw.view(np.int64)),
                    torch.from_numpy(valid), source=b % 2)
    got = port_tables(t)
    assert_same_shards(got, jax_tables(j))
    assert any((g[0] == np.uint64(2 ** 64 - 1)).any() for g in got)
    np.testing.assert_array_equal(t.total_added, np.asarray(j.total_added))


def jax_u32(a):
    import jax.numpy as jnp

    return jnp.asarray(a, jnp.uint32)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, 8, 64])
def test_owner_hash_is_the_jax_function(n_shards):
    rng = np.random.default_rng(n_shards)
    hi = rng.integers(0, 2 ** 32, 5000, np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2 ** 32, 5000, np.uint64).astype(np.uint32)
    hi[:4] = [0, 2 ** 32 - 1, 0, 2 ** 32 - 1]
    lo[:4] = [0, 0, 2 ** 32 - 1, 2 ** 32 - 1]
    want = np.asarray(jowner_hash(jax_u32(hi), jax_u32(lo), n_shards))
    got = owner_hash(torch.from_numpy(hi.astype(np.int64)),
                     torch.from_numpy(lo.astype(np.int64)), n_shards)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spill_per_shard_to_memory_and_files(tmp_path):
    """A spill budget below one run: every shard spills its own runs (to
    host memory, or to files that are gone after the fold) and the tables
    equal the unspilled store's."""
    k = 21
    mesh = make_mesh(4, device=CPU)
    plain = ShardedCountStore(k, mesh)
    mem = ShardedCountStore(k, mesh, spill_bytes=4096)
    disk = ShardedCountStore(k, mesh, spill_bytes=4096,
                             spill_dir=str(tmp_path))
    min_ll = float(Q_TO_LL[33])
    for b in range(4):
        tens = [torch.from_numpy(a) for a in read_batch(700 + b)]
        for st in (plain, mem, disk):
            st.add_reads(*tens, min_ll, precision="exact", with_noq=True,
                         min_q_char=33)
    assert list(tmp_path.glob("kmh_spill_*"))
    for st in (mem, disk):
        tm = st.shard_timings()
        assert tm["spills"] >= 4 and tm["spilled_rows"] > 0
        assert_same_shards(port_tables(st), port_tables(plain))
        np.testing.assert_array_equal(st.total_added, plain.total_added)
    assert not list(tmp_path.glob("kmh_spill_*"))


def write_fastq(path, seed, rows=600):
    seq, qual, lengths, hq = read_batch(seed, rows)
    with open(path, "wb") as f:
        for i in range(rows):
            n = int(lengths[i])
            q = qual[i, :n].tobytes() if hq[i] else b"I" * n
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq[i, :n].tobytes(), q))
    return str(path)


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """(a FASTQ file, the JAX sharded store of it on 8 devices, the port's,
    the port's single store) through ``count_kmers_fq_sh_rp(mesh=)``, k =
    21, hybrid: more than 64 rows in every shard."""
    fq = write_fastq(tmp_path_factory.mktemp("ck") / "a.fq", 1)
    kw = dict(k=21, min_q=0, exact_ll="hybrid")
    j = japi.count_kmers_fq_sh_rp(fq, mesh=jmake_mesh(8), **kw)
    t = api.count_kmers_fq_sh_rp(fq, mesh=make_mesh(8, device=CPU),
                                 report_every=100, batch_rows=256, **kw)
    one = api.count_kmers_fq_sh_rp(fq, device=CPU, batch_rows=256, **kw)
    assert int(np.asarray(j.n_unique).min()) > 64
    return fq, j, t, one


def test_file_entry_with_mesh_equals_one_store_and_jax(counted, tmp_path):
    """``count_kmers_fq_sh_rp(mesh=)``: one file against the port's single
    store and the JAX package's sharded count; a file list; a run cut by
    max_reads with checkpoints and resumed by skip_reads."""
    fq, j, sh, one = counted
    fq2 = write_fastq(tmp_path / "b.fq", 2)
    mesh = make_mesh(8, device=CPU)
    kw = dict(k=21, min_q=0, exact_ll="hybrid", batch_rows=256)
    assert isinstance(sh, ShardedCountStore) and sh.device.type == "cpu"
    assert_union_is(sh, one)
    assert_same_shards(port_tables(sh), jax_tables(j))
    both = api.count_kmers_fq_sh_rp([fq, fq2], mesh=mesh, source_n=2, **kw)
    one2 = api.count_kmers_fq_sh_rp(fq2, store=api.count_kmers_fq_sh_rp(
        fq, device=CPU, source_n=2, **kw), **kw)
    assert_union_is(both, one2)
    ck = str(tmp_path / "ck.npz")
    part = api.count_kmers_fq_sh_rp(fq, mesh=mesh, max_reads=300,
                                    checkpoint_every=256,
                                    checkpoint_path=ck, **kw)
    prog = tckpt.load_progress(ck)
    assert prog == {"path": fq, "reads_done": 300, "done": False}
    back = tckpt.load_count_store(ck, mesh=mesh)
    assert_same_shards(port_tables(back), port_tables(part))
    done = api.count_kmers_fq_sh_rp(fq, mesh=mesh, store=back,
                                    skip_reads=300, **kw)
    assert_union_is(done, one)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq, mesh=make_mesh(4, device=CPU),
                                 store=done, **kw)
    with pytest.raises(ValueError):
        api.count_kmers_fq_sh_rp(fq, mesh=mesh, store=one, **kw)


def test_count_verb_with_mesh(tmp_path, capsys):
    """``count --mesh 8`` (and ``--mesh 8 --mesh-slices 2``) through
    ``main(argv)``: the sharded file, the JSON line's shard sizes, a cut run
    resumed with ``--resume``, and ``spectrum`` / ``depth`` of the file,
    against the same verbs without ``--mesh``."""
    fq = write_fastq(tmp_path / "r.fq", 3, rows=900)
    ref = tmp_path / "ref.fa"
    seq, _q, lengths, _h = read_batch(3, 900)
    ref.write_bytes(b">ref\n" + seq[5, : lengths[5]].tobytes() + b"\n")
    base = ["count", fq, "-k", "21", "--min-q", "0", "--ll-mode", "hybrid",
            "--device", "cpu"]

    def run(argv):
        tcli.main([str(a) for a in argv])
        return capsys.readouterr().out.strip().splitlines()

    one = json.loads(run(base + ["-o", tmp_path / "one.npz"])[-1])
    for extra, out in ((["--mesh", "8"], "sh.npz"),
                       (["--mesh", "8", "--mesh-slices", "2"], "sl.npz")):
        info = json.loads(run(base + extra + ["-o", tmp_path / out])[-1])
        assert info["distinct"] == one["distinct"] == sum(info["shards"])
        assert len(info["shards"]) == 8
        assert info["total_added"] == one["total_added"]
        with np.load(tmp_path / out) as z:
            meta = json.loads(str(z["meta"]))
        assert meta["kind"] == "sharded_count_store" and meta["n_shards"] == 8
    cut = run(base + ["--mesh", "8", "--max-reads", "500",
                      "--checkpoint-every", "256", "-o", tmp_path / "ck.npz"])
    assert json.loads(cut[-1])["distinct"] < one["distinct"]
    run(base + ["--mesh", "8", "--resume", tmp_path / "ck.npz",
                "--checkpoint-every", "256", "-o", tmp_path / "ck.npz"])
    whole = tckpt.load_count_store(tmp_path / "one.npz", device=CPU)
    for name in ("sh.npz", "sl.npz", "ck.npz"):
        got = tckpt.load_count_store(tmp_path / name, device=CPU)
        assert torch.equal(got.keys, whole.keys), name
        assert torch.equal(got.cnt, whole.cnt), name
    assert run(["spectrum", tmp_path / "sh.npz", "--device", "cpu"]) == run(
        ["spectrum", tmp_path / "one.npz", "--device", "cpu"])
    for name in ("sh", "one"):
        run(["depth", tmp_path / f"{name}.npz", ref, "-k", "21", "-o",
             tmp_path / f"{name}.npy", "--device", "cpu"])
    assert np.array_equal(np.load(tmp_path / "sh.npy"),
                          np.load(tmp_path / "one.npy"))
    with pytest.raises(SystemExit):
        tcli.main([str(a) for a in base + ["--mesh", "8", "--mesh-slices",
                                           "3", "-o", tmp_path / "x.npz"]])


def test_mesh_layouts():
    g = make_hierarchical_mesh(2, 4, device=CPU)
    assert (g.size, g.shape, g.axis_names) == (8, (2, 4), ("dcn", "ici"))
    assert make_mesh(device=CPU).size == 1
    parts = make_mesh(3, device=CPU).exchange(
        torch.tensor([2, 0, 2, 1, 0]), torch.arange(5))
    assert [p[0].tolist() for p in parts] == [[1, 4], [3], [0, 2]]
    with pytest.raises(ValueError):
        make_mesh(2, device=CPU).exchange(torch.tensor([0, 2]),
                                          torch.arange(2))
    with pytest.raises(ValueError):
        make_mesh(0, device=CPU)


def test_jax_sharded_file_loads_in_the_port(counted, tmp_path):
    fq, j, t, one = counted
    p = tmp_path / "j.npz"
    jckpt.save_count_store(j, p)
    got = tckpt.load_count_store(p, mesh=make_mesh(8, device=CPU))
    assert_same_shards(port_tables(got), jax_tables(j))
    np.testing.assert_array_equal(got.total_added, np.asarray(j.total_added))
    assert_union_is(got, one)
    whole = tckpt.load_count_store(p, device=CPU)
    assert torch.equal(whole.keys, one.keys) and torch.equal(whole.cnt,
                                                             one.cnt)
    with pytest.raises(ValueError, match="8 shards"):
        tckpt.load_count_store(p, mesh=make_mesh(4, device=CPU))


def test_port_sharded_file_loads_in_jax(counted, tmp_path, monkeypatch):
    """Onto the JAX mesh, shard by shard; folded into one JAX store with
    its run trimming off. With trimming on, the JAX package's own
    single-store restore keeps 64 rows of each shard (its fault, left as
    it is); the port's restores keep every row."""
    fq, j, t, one = counted
    p = tmp_path / "t.npz"
    tckpt.save_count_store(t, p)
    with np.load(p) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["kind"] == "sharded_count_store"
    assert meta["n_unique"] == np.asarray(j.n_unique).tolist()
    back = jckpt.load_count_store(p, mesh=jmake_mesh(8))
    assert_same_shards(jax_tables(back), jax_tables(j))
    np.testing.assert_array_equal(np.asarray(back.total_added),
                                  t.total_added)
    monkeypatch.setattr(jcs, "_TRIM_RUNS", False)
    whole = jckpt.load_count_store(p)
    assert whole.counts_dict() == one.counts_dict()
    monkeypatch.setattr(jcs, "_TRIM_RUNS", True)
    assert jckpt.load_count_store(p).n_unique < one.n_unique
    again = tckpt.load_count_store(p, mesh=make_mesh(8, device=CPU))
    assert_same_shards(port_tables(again), port_tables(t))
    assert all(int(n) > 64 for n in again.n_unique)
