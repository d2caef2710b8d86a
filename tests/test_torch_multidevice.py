"""The port's shard groups spread over several devices of one process
(``make_mesh(8, device="cpu", devices=["cpu"] * M)`` for M in 1, 2, 4, 8)
against the same group on one device, the port's single store and index,
and the JAX package on its 8-device virtual CPU mesh (``conftest.py``),
shard by shard and bitwise: the sharded count store (k = 21 and 31; fast,
exact and hybrid), the sharded index (k = 5, 21, 32 on a mixed, a
trailing-exact-k and a 40-base input: tables, lookups, ``seq_kmer_pos``,
``kmer_pairs_sharded``), sharded checkpoints both ways, ``count --mesh 8
--mesh-devices 2`` against the JAX CLI's ``--mesh 8``, the twin of
``dryrun_multichip`` against the JAX run's recorded line, and the
errors. Every device here is the CPU, so the code paths of a spread group
run (rows dealt to devices, one exchange source a device, results
gathered to the home device) without a card. The layout "split" names the
CPU twice by two device objects that compare unequal (``cpu`` and
``cpu:0``): every copy to "the other" device is then counted in the
exchange's and the gathers' bytes, and each shard's store records its
own device, so a shard placed on the home device where its own was meant
shows."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (x64, the JAX package's setting)
from kmer_hasher_tpu import __main__ as jcli
from kmer_hasher_tpu.index import count_store as jcs
from kmer_hasher_tpu.parallel import ShardedCountStore as JShardedCountStore
from kmer_hasher_tpu.parallel import ShardedKmerIndex as JShardedKmerIndex
from kmer_hasher_tpu.parallel import make_mesh as jmake_mesh
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch import __main__ as tcli
from kmer_hasher_tpu_torch import counting
from kmer_hasher_tpu_torch.counting import win_bucket
from kmer_hasher_tpu_torch.index import KmerIndex
from kmer_hasher_tpu_torch.index.query import kmer_pairs, seq_kmer_pos
from kmer_hasher_tpu_torch.multichip import dryrun_multichip
from kmer_hasher_tpu_torch.ops import encode as enc
from kmer_hasher_tpu_torch.parallel import (ShardedCountStore,
                                            ShardedKmerIndex,
                                            kmer_pairs_sharded,
                                            make_hierarchical_mesh,
                                            make_mesh, owner_of_keys)
from kmer_hasher_tpu_torch.qll import Q_TO_LL
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

CPU = "cpu"
D = 8
MS = (1, 2, 4, 8)
SPLIT = "split"
LAYOUTS = MS + (SPLIT,)
READ_LEN = 100
MIN_Q = 0  # borderline-rich: the f32 filter flags reads for hybrid
ROOT = Path(__file__).resolve().parent.parent


def spread(m):
    """8 shards over M CPU devices; ``SPLIT``: over two that differ."""
    if m == SPLIT:
        return make_mesh(D, device=CPU, devices=[CPU, torch.device(CPU, 0)])
    return make_mesh(D, device=CPU, devices=[CPU] * m)


def assert_moved(stats: dict, key: str, mesh):
    """Bytes crossed devices exactly where the group's devices differ."""
    if mesh.devices[0] != mesh.devices[-1]:
        assert stats[key] > 0
    elif mesh.multi_device:
        assert stats[key] == 0  # every device the same CPU


def read_batch(seed: int, rows: int = 256):
    """Host (seq, qual, lengths, has_qual): random bases with 1% N,
    lengths 40-100 padded with N, 10% of qualities at q0-q6, 5% of rows
    without qualities; ``rows`` need not be a multiple of D."""
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


BATCHES = [read_batch(11, 253), read_batch(12, 256)]  # 253: padded to 256


def pad_rows(batch):
    """A batch padded with empty rows to a multiple of D (the JAX store
    takes D rows' multiples only)."""
    pad = -len(batch[2]) % D
    return tuple(np.concatenate([a, np.full((pad, *a.shape[1:]), fill,
                                            a.dtype)])
                 for a, fill in zip(batch, (ord("N"), 0, 0, False)))


EXACT = {"fast": False, "exact": True, "hybrid": "hybrid"}


def port_tables(st):
    st.flush()
    return [(((s.keys.cpu() ^ -(2 ** 63)).numpy().view(np.uint64)),
             s.cnt.cpu().numpy()) for s in st.shards]


def jax_tables(st):
    n = np.asarray(st.n_unique)
    hi, lo, cnt = (np.asarray(a) for a in (st.u_hi, st.u_lo, st.cnt))
    raw = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return [(raw[d, : n[d]], cnt[d, : n[d]].astype(np.int64))
            for d in range(len(n))]


def assert_same_shards(a, b):
    assert len(a) == len(b)
    for (ka, ca), (kb, cb) in zip(a, b):
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(ca, cb)


def count(mesh, k: int, precision: str):
    """The two batches through ``count_batches`` (the file entry's loop),
    batch b as source b of two."""
    st = ShardedCountStore(k, mesh, counts_n=2)
    for b, batch in enumerate(BATCHES):
        counting.count_batches(st, [batch], k, min_q=MIN_Q, source=b,
                               exact_ll=EXACT[precision])
    return st


_STORES = {}


def logical(k: int, precision: str):
    """The 8 shards on one device, counted once."""
    if (k, precision) not in _STORES:
        _STORES[k, precision] = count(make_mesh(D, device=CPU), k, precision)
    return _STORES[k, precision]


_JSTORES = {}


def jax_store(k: int, precision: str):
    """The JAX store on its 8 devices; hybrid is held against exact."""
    precision = "exact" if precision == "hybrid" else precision
    if (k, precision) not in _JSTORES:
        j = JShardedCountStore(k, jmake_mesh(D), counts_n=2)
        min_ll = float(Q_TO_LL[33 + MIN_Q])
        for b, batch in enumerate(BATCHES):
            seq, qual, lengths, hq = pad_rows(batch)
            j.add_reads(seq, qual, lengths, hq, min_ll, precision=precision,
                        source=b, with_noq=bool((~hq & (lengths > k)).any()),
                        min_q_char=33 + MIN_Q,
                        n_win=win_bucket(lengths.max(), k), with_q=True)
        _JSTORES[k, precision] = j
    return _JSTORES[k, precision]


@pytest.mark.parametrize("precision", ["fast", "exact", "hybrid"])
@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("m", LAYOUTS)
def test_store_over_devices_equals_logical_and_jax(m, k, precision):
    st = count(spread(m), k, precision)
    one, j = logical(k, precision), jax_store(k, precision)
    assert [s.device for s in st.shards] == [st.mesh.device_of(d)
                                             for d in range(D)]
    assert st.mesh.multi_device == (m != 1)
    got = port_tables(st)
    assert_same_shards(got, port_tables(one))
    assert_same_shards(got, jax_tables(j))
    for d, s in enumerate(st.shards):
        assert bool((owner_of_keys(s.keys, D) == d).all())
    np.testing.assert_array_equal(st.n_unique, np.asarray(j.n_unique))
    np.testing.assert_array_equal(st.total_added, one.total_added)
    np.testing.assert_array_equal(st.total_added, np.asarray(j.total_added))
    np.testing.assert_array_equal(st.spectrum(300), one.spectrum(300))
    args = (50, [1, 2, 3], [0, 1, 1], [1, 1])
    np.testing.assert_array_equal(st.spectrum_n(*args),
                                  np.asarray(j.spectrum_n(*args)))
    q = torch.cat([s.keys for s in one.shards])[::5] ^ -(2 ** 63)
    q = torch.cat([q, torch.tensor([0, 12345], dtype=torch.int64)])
    assert torch.equal(st.lookup(q), one.lookup(q))
    assert st.peek_n_unique() == int(one.n_unique.sum())
    if st.mesh.multi_device:
        assert st.timings["exchanges"] >= len(BATCHES)
        assert_moved(st.timings, "exchange_bytes", st.mesh)


def test_add_reads_deals_rows_to_every_device(monkeypatch):
    """``add_reads`` over 4 devices runs the batch pipeline once a device,
    on a contiguous block of the padded batch, and sweeps the flagged rows
    of each block on its device; hybrid equals exact."""
    blocks = []
    real = counting._fused_rp_batch

    def spy(seq, *a, **kw):
        blocks.append(seq.shape[0])
        return real(seq, *a, **kw)

    monkeypatch.setattr(counting, "_fused_rp_batch", spy)
    seq, qual, lengths, hq = (torch.from_numpy(a) for a in BATCHES[0])
    st = ShardedCountStore(21, spread(4), counts_n=2)
    st.add_reads(seq, qual, lengths, hq, float(Q_TO_LL[33]),
                 precision="hybrid", with_noq=True, min_q_char=33,
                 n_win=win_bucket(int(lengths.max()), 21))
    assert blocks[:4] == [64] * 4 and len(blocks) > 4  # then the sweeps
    ex = ShardedCountStore(21, make_mesh(D, device=CPU), counts_n=2)
    ex.add_reads(seq, qual, lengths, hq, float(Q_TO_LL[33]),
                 precision="exact", with_noq=True, min_q_char=33,
                 n_win=win_bucket(int(lengths.max()), 21))
    assert_same_shards(port_tables(st), port_tables(ex))


@pytest.mark.parametrize("m", [2, SPLIT])
def test_spill_over_devices(m, tmp_path):
    """A spill budget below one run on a spread group: every shard spills
    its own runs, on its own device, to host memory or to files, and the
    tables equal the unspilled one-device group's."""
    k, min_ll = 21, float(Q_TO_LL[33])
    plain = ShardedCountStore(k, make_mesh(D, device=CPU))
    mem = ShardedCountStore(k, spread(m), spill_bytes=4096)
    disk = ShardedCountStore(k, spread(m), spill_bytes=4096,
                             spill_dir=str(tmp_path))
    for b in range(3):
        tens = [torch.from_numpy(a) for a in read_batch(700 + b)]
        for st in (plain, mem, disk):
            st.add_reads(*tens, min_ll, precision="exact", with_noq=True,
                         min_q_char=33)
    assert list(tmp_path.glob("kmh_spill_*"))
    for st in (mem, disk):
        assert [s.device for s in st.shards] == [st.mesh.device_of(d)
                                                 for d in range(D)]
        tm = st.shard_timings()
        assert tm["spills"] >= 3 and tm["spilled_rows"] > 0
        assert_same_shards(port_tables(st), port_tables(plain))
        np.testing.assert_array_equal(st.total_added, plain.total_added)
        assert_moved(st.timings, "exchange_bytes", st.mesh)
    assert not list(tmp_path.glob("kmh_spill_*"))


# -- the sharded index --------------------------------------------------------

LONG = 3000


def mixed_seq() -> np.ndarray:
    rng = np.random.default_rng(20261017)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=LONG)
    for a in rng.integers(0, LONG - 50, size=6):
        seq[a: a + int(rng.integers(1, 30))] = ord("N")
    seq[1500:1800] = seq[200:500]
    seq[2300:2340] = ord("G")
    return seq


def quirk_seq(k: int) -> np.ndarray:
    seq = mixed_seq()
    seq[LONG - k - 1] = ord("N")
    seq[LONG - k:] = np.frombuffer(b"ACGT" * 8, np.uint8)[:k]
    return seq


def short_seq() -> np.ndarray:
    rng = np.random.default_rng(40)
    return rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=40)


INPUTS = {"mixed": lambda k: mixed_seq(), "quirk": quirk_seq,
          "short": lambda k: short_seq()}
_SINGLE, _JIDX = {}, {}


def single(name: str, k: int) -> KmerIndex:
    if (name, k) not in _SINGLE:
        _SINGLE[name, k] = KmerIndex(INPUTS[name](k), k, device=CPU)
    return _SINGLE[name, k]


def jax_index(name: str, k: int):
    if (name, k) not in _JIDX:
        _JIDX[name, k] = JShardedKmerIndex(INPUTS[name](k), k,
                                           jmake_mesh(D))
    return _JIDX[name, k]


def to_raw(s_key: torch.Tensor) -> np.ndarray:
    return enc.sortable_key(s_key).numpy().view(np.uint64)


@pytest.mark.parametrize("name", ["mixed", "quirk", "short"])
@pytest.mark.parametrize("k", [5, 21, 32])
@pytest.mark.parametrize("m", LAYOUTS)
def test_index_over_devices_equals_single_and_jax(m, k, name):
    seq = INPUTS[name](k)
    t = ShardedKmerIndex(seq, k, spread(m))
    one = single(name, k)
    assert t.total_kmers == one.n_valid
    got, want = t.tables(15), one.tables(15)
    assert got["kmer"] == want["kmer"]
    for f in ("pos", "pair.pos", "count"):
        assert torch.equal(got[f], want[f]), f
    chunks = list(t.iter_pair_chunks(capacity=64))
    assert all(c.shape[0] <= 64 for c in chunks)
    assert torch.equal(torch.cat(chunks) if chunks else got["pair.pos"],
                       want["pair.pos"])
    q = torch.unique(one.s_key[: one.n_valid]) ^ enc.SIGN
    q2 = torch.cat([q, torch.tensor([0, 2 ** 40 + 7], dtype=torch.int64)])
    lb, ub = one.lookup_range(q2)
    assert torch.equal(t.lookup_counts(q2).long(), ub - lb)
    assert torch.equal(t.positions_of(q, max_hits_per_shard=64),
                       torch.sort(one.s_pos[: one.n_valid]).values)
    if k <= 31:
        query = seq if name == "short" else np.concatenate(
            [seq[100:700], np.frombuffer(b"N", np.uint8), seq[1450:1900]])
        blocks = list(t.iter_seq_kmer_pos(query, k, max_hits_per_shard=64))
        assert torch.equal(torch.cat(blocks) if blocks else t.seq_kmer_pos(
            query, k), seq_kmer_pos(one, query, k))
    other = short_seq() if name == "short" else quirk_seq(k)
    tb = ShardedKmerIndex(other, k, t.mesh)
    assert torch.equal(kmer_pairs_sharded(t, tb, capacity=64), kmer_pairs(
        one, KmerIndex(other, k, device=CPU)))
    if t.total_kmers:
        assert_moved(t.timings, "exchange_bytes", t.mesh)
    if k in (21, 32) and name != "short":  # the JAX index's halo fits
        j = jax_index(name, k)
        for d, s in enumerate(t.shards):
            n = int(j.n_valid[d])
            raw = ((np.asarray(j.s_hi[d, :n]).astype(np.uint64)
                    << np.uint64(32)) | np.asarray(j.s_lo[d, :n]))
            np.testing.assert_array_equal(to_raw(s.s_key), raw)
            np.testing.assert_array_equal(s.s_pos.numpy(), j.s_pos[d, :n])
        jt = j.tables(15)
        assert got["kmer"] == jt["kmer"]
        for f in ("pos", "pair.pos", "count"):
            np.testing.assert_array_equal(got[f].numpy(), jt[f])


# -- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize("m", LAYOUTS)
def test_checkpoints_cross_devices_and_packages(m, tmp_path, monkeypatch):
    """A spread group's file onto the one-device group, the JAX mesh and
    one store; the one-device group's and the JAX package's files onto
    the spread group."""
    st, one = count(spread(m), 21, "exact"), logical(21, "exact")
    j = jax_store(21, "exact")
    p_spread, p_one, p_jax = (tmp_path / f"{n}.npz"
                              for n in ("spread", "one", "jax"))
    tckpt.save_count_store(st, p_spread)
    tckpt.save_count_store(one, p_one)
    jckpt.save_count_store(j, p_jax)
    assert_same_shards(port_tables(tckpt.load_count_store(
        p_spread, mesh=make_mesh(D, device=CPU))), port_tables(one))
    assert_same_shards(jax_tables(jckpt.load_count_store(
        p_spread, mesh=jmake_mesh(D))), jax_tables(j))
    for p in (p_one, p_jax, p_spread):
        back = tckpt.load_count_store(p, mesh=spread(m))
        assert back.mesh.devices == spread(m).devices
        assert [s.device for s in back.shards] == [
            back.mesh.device_of(d) for d in range(D)]
        assert_same_shards(port_tables(back), port_tables(one))
        np.testing.assert_array_equal(back.total_added, one.total_added)
    whole = tckpt.load_count_store(p_spread, device=CPU)
    monkeypatch.setattr(jcs, "_TRIM_RUNS", False)
    assert whole.counts_dict() == jckpt.load_count_store(
        p_jax).counts_dict()


def write_fastq(path, batch):
    seq, qual, lengths, hq = batch
    with open(path, "wb") as f:
        for i in range(len(lengths)):
            n = int(lengths[i])
            q = qual[i, :n].tobytes() if hq[i] else b"I" * n
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq[i, :n].tobytes(), q))
    return str(path)


@pytest.mark.parametrize("slices", [None, 2])
def test_count_verb_over_devices_equals_the_jax_cli(slices, tmp_path,
                                                    capsys):
    """``count --mesh 8 --mesh-devices 2 --device cpu`` (and with
    ``--mesh-slices 2``) against the JAX CLI's ``count --mesh 8``: the JSON
    line's shard sizes and the saved shard tables."""
    fq = write_fastq(tmp_path / "r.fq", read_batch(13, 300))
    base = ["count", fq, "-k", "21", "--min-q", "0", "--ll-mode", "hybrid",
            "--mesh", "8"] + (["--mesh-slices", str(slices)] if slices
                              else [])
    tcli.main(base + ["--mesh-devices", "2", "--device", "cpu", "-o",
                      str(tmp_path / "t.npz")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(base + ["-o", str(tmp_path / "j.npz")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["shards"] == want["shards"]
    assert got["distinct"] == want["distinct"] and got["distinct"] > 0
    assert got["total_added"] == want["total_added"]
    a = tckpt.load_count_store(tmp_path / "t.npz", mesh=spread(2))
    b = tckpt.load_count_store(tmp_path / "j.npz", mesh=spread(2))
    assert_same_shards(port_tables(a), port_tables(b))
    with pytest.raises(SystemExit):
        tcli.main(["count", fq, "-k", "21", "--mesh", "8", "--mesh-devices",
                   "3", "--device", "cpu", "-o", str(tmp_path / "x.npz")])


@pytest.mark.parametrize("m", MS)
def test_dryrun_multichip_equals_the_jax_run(m, capsys):
    """The twin of ``__graft_entry__.dryrun_multichip(8)``: the line the
    JAX run printed (``MULTICHIP_r05.json``), on 8 shards over M CPU
    devices."""
    tail = json.loads((ROOT / "MULTICHIP_r05.json").read_text())["tail"]
    want = [ln for ln in tail.splitlines() if "dryrun_multichip OK" in ln]
    rec = dryrun_multichip(8, device=CPU, devices=[CPU] * m)
    assert rec["ok"] and rec["line"] == want[-1]
    assert capsys.readouterr().out.strip().splitlines()[-1] == want[-1]
    assert rec["devices"] == [CPU] * m


# -- layouts and errors -------------------------------------------------------

@pytest.mark.parametrize("m", MS)
def test_layout_over_devices(m):
    g = spread(m)
    assert g.devices == (torch.device(CPU),) * m and g.device.type == CPU
    assert [g.device_of(d) for d in range(D)] == [torch.device(CPU)] * D
    per = D // m
    assert [g.shards_on(i) for i in range(m)] == [
        range(i * per, (i + 1) * per) for i in range(m)]
    h = make_hierarchical_mesh(2, 4, device=CPU, devices=[CPU] * m)
    assert (h.size, h.shape, h.devices) == (D, (2, 4), g.devices)
    parts = g.exchange([torch.tensor([7, 0, 7]), torch.tensor([0, 3])],
                       [torch.arange(3), torch.arange(10, 12)],
                       by_rank=True)
    assert [[p[0].tolist() for p in parts[d]] for d in (0, 3, 7)] == [
        [[1], [10]], [[], [11]], [[0, 2], []]]
    assert make_mesh(D, device=CPU).devices == (torch.device(CPU),)


def test_split_layout_places_and_counts_bytes():
    """Over ``cpu`` and ``cpu:0`` the second device holds shards 4-7, and
    what the exchange copies there is counted; a group repeating one
    device copies nothing."""
    g = spread(SPLIT)
    assert [g.device_of(d) for d in range(D)] == (
        [torch.device(CPU)] * 4 + [torch.device(CPU, 0)] * 4)
    assert g.device == torch.device(CPU)
    owner = torch.tensor([0, 5, 7, 3, 5])
    for mesh, moved in ((g, 3 * 8), (spread(2), 0)):
        stats = {}
        parts = mesh.exchange(owner, torch.arange(5), stats=stats)
        assert [p[0].tolist() for p in parts] == [
            [0], [], [], [3], [], [1, 4], [], [2]]
        assert stats["exchanges"] == 1 and stats["exchange_bytes"] == moved


def test_errors(monkeypatch):
    with pytest.raises(ValueError, match="evenly"):
        make_mesh(D, device=CPU, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="evenly"):
        make_mesh(D, device=CPU, devices=[])
    # both spreads combine now; over processes they need the process group
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(D, device=CPU, distributed=True, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(D, devices=["cuda", CPU])
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(D, device=CPU, devices=["cuda:1"] * 2)
    a = ShardedKmerIndex(mixed_seq(), 21, spread(2))
    b = ShardedKmerIndex(mixed_seq(), 21, make_mesh(D, device=CPU))
    with pytest.raises(ValueError, match="same mesh"):
        kmer_pairs_sharded(a, b)
