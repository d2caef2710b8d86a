"""The port's sharded position index on 8 logical CPU shards against the
JAX package's ``ShardedKmerIndex`` on the 8-device virtual CPU mesh
(``conftest.py``) and against the port's single ``KmerIndex``: the hash
shards, the splitters and range shards, every table, the lookups, the
streamed queries and the cross-index pairs, bitwise; the errors and the
range partition's release (``sort_windows`` with explicit positions, the
routed rows' sort, is in ``test_torch_sort.py``).

Inputs are seeded: a mixed sequence (ACGT in both cases, N runs, a
repeated unit and a run of 40 G, so k = 32 has real all-G windows), the
same with N plus exactly k bases at its end (the trailing-exact-k quirk),
40 bases on 8 shards (chunks past the end, B1 rows of length <= 0), and a
repeat-rich sequence whose queries drain in many chunks. The JAX shapes are
kept few (one chunk size for the long inputs), since each compiles its own
shard_map programs."""
import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (x64, the JAX package's setting)
from kmer_hasher_tpu.index import KmerIndex as JKmerIndex
from kmer_hasher_tpu.index.query import kmer_pairs as jkmer_pairs
from kmer_hasher_tpu.parallel import ShardedKmerIndex as JShardedKmerIndex
from kmer_hasher_tpu.parallel import iter_kmer_pairs_sharded_chunks as jiter
from kmer_hasher_tpu.parallel import kmer_pairs_sharded as jkmer_pairs_sh
from kmer_hasher_tpu.parallel import make_mesh as jmake_mesh
from kmer_hasher_tpu.parallel import sharded as jsp
from kmer_hasher_tpu_torch.index import KmerIndex
from kmer_hasher_tpu_torch.index.query import kmer_pairs, seq_kmer_pos
from kmer_hasher_tpu_torch.ops import encode as enc
from kmer_hasher_tpu_torch.parallel import (ShardedKmerIndex,
                                            iter_kmer_pairs_sharded_chunks,
                                            kmer_pairs_sharded, make_mesh,
                                            owner_hash)
from kmer_hasher_tpu_torch.parallel import sharded as tsp

CPU = "cpu"
D = 8
KS = (5, 16, 21, 31, 32)  # k = 1 on the short input: its tables are small
LONG = 3000  # one chunk size (512) for every long input
REPEAT = "ACTGG" * 400 + "T" + "ACGTACGTAA" * 40  # 2,401 bases


def mixed_seq() -> np.ndarray:
    rng = np.random.default_rng(20261017)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=LONG)
    for a in rng.integers(0, LONG - 50, size=6):
        seq[a: a + int(rng.integers(1, 30))] = ord("N")
    seq[1500:1800] = seq[200:500]  # a repeated unit
    seq[2300:2340] = ord("G")  # nine all-G 32-mers
    return seq


def quirk_seq(k: int) -> np.ndarray:
    """The mixed sequence ending in N and then exactly k bases."""
    seq = mixed_seq()
    seq[LONG - k - 1] = ord("N")
    seq[LONG - k:] = np.frombuffer(b"ACGT" * 8, np.uint8)[:k]
    return seq


def short_seq() -> np.ndarray:
    rng = np.random.default_rng(40)
    return rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=40)


INPUTS = {"mixed": lambda k: mixed_seq(), "quirk": quirk_seq,
          "short": lambda k: short_seq()}


@pytest.fixture(scope="module")
def meshes():
    return jmake_mesh(D), make_mesh(D, device=CPU)


_BUILT = {}


def built(meshes, name: str, k: int):
    """(JAX sharded, port sharded, port single) of one input, built once."""
    if (name, k) not in _BUILT:
        seq = INPUTS[name](k)
        _BUILT[name, k] = (JShardedKmerIndex(seq, k, meshes[0]),
                           ShardedKmerIndex(seq, k, meshes[1]),
                           KmerIndex(seq, k, device=CPU))
    return _BUILT[name, k]


def raw_np(s_key: torch.Tensor) -> np.ndarray:
    """Sortable keys -> raw patterns as uint64."""
    return enc.sortable_key(s_key).numpy().view(np.uint64)


def jraw(hi, lo) -> np.ndarray:
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))


def to_raw_i64(keys_u64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys_u64).view(np.int64))


def assert_rows(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# 40 bases make chunks of 16: the JAX package builds only where the halo
# of k-1 bases fits in one chunk (k <= 17; past it, its concatenation of a
# chunk and a cut of its neighbour fails). The port's rows reach as far as
# they need: test_halo_longer_than_a_chunk.
CASES = [("mixed", k) for k in KS] + [("quirk", k) for k in (5, 21, 32)] + [
    ("short", k) for k in (1, 5, 16)]


@pytest.mark.parametrize("name,k", CASES)
def test_hash_shards_equal_jax(meshes, name, k):
    j, t, one = built(meshes, name, k)
    np.testing.assert_array_equal(t.n_valid, np.asarray(j.n_valid))
    assert t.n_valid.dtype == np.int64
    assert (t.chunk, t.seq_len, t.n_shards) == (j.chunk, j.seq_len, D)
    assert t.total_kmers == j.total_kmers == one.n_valid
    for d, s in enumerate(t.shards):
        n = int(t.n_valid[d])
        np.testing.assert_array_equal(
            raw_np(s.s_key), jraw(j.s_hi[d, :n], j.s_lo[d, :n]))
        assert_rows(s.s_pos, np.asarray(j.s_pos[d, :n]))
        hi, lo = enc.split_hi_lo(enc.sortable_key(s.s_key))
        assert bool((owner_hash(hi, lo, D) == d).all())
    if name == "short":  # chunks 3..7 lie past the end
        assert t.chunk == 16 and 3 * t.chunk > t.seq_len
    if name == "quirk":  # the last window starts a fresh region: dropped
        assert int(torch.cat([s.s_pos for s in t.shards]).max()) < LONG - k + 1


@pytest.mark.parametrize("name,k", CASES)
def test_range_partition_equals_jax(meshes, name, k):
    """The splitters and every range shard, where every hash shard holds a
    window (or k > 16, where an empty shard samples the same all-ones key
    in both packages); the range shards are key-ordered either way."""
    j, t, _ = built(meshes, name, k)
    rp = t._range_partitioned()
    assert t._range_partitioned() is rp  # cached
    keys = torch.cat([s.s_key for s in rp])
    assert bool((keys[1:] >= keys[:-1]).all())
    assert sum(s.n_valid for s in rp) == t.total_kmers
    if not ((t.n_valid > 0).all() or k > 16):
        return
    r_hi, r_lo, r_pos, nv = j._range_partitioned()
    np.testing.assert_array_equal(raw_np(t._rp_spl),
                                  jraw(j._rp_spl[0], j._rp_spl[1]))
    np.testing.assert_array_equal([s.n_valid for s in rp], nv)
    for d, s in enumerate(rp):
        n = int(nv[d])
        np.testing.assert_array_equal(raw_np(s.s_key),
                                      jraw(r_hi[d, :n], r_lo[d, :n]))
        assert_rows(s.s_pos, np.asarray(r_pos[d, :n]))


@pytest.mark.parametrize("name,k", CASES)
def test_tables_equal_jax_and_single(meshes, name, k):
    j, t, one = built(meshes, name, k)
    got, want, single = t.tables(15), j.tables(15), one.tables(15)
    assert got["kmer"] == want["kmer"] == single["kmer"]
    for f in ("pos", "pair.pos", "count"):
        assert_rows(got[f], want[f])
        assert torch.equal(got[f], single[f]), f
    assert t.n_kmers == j.n_kmers == one.n_kmers
    assert t.total_pairs == j.total_pairs == one.total_pairs
    assert t.kmer_strings() == j.kmer_strings()
    assert_rows(t.counts(), j.counts())
    assert_rows(t.pos_table(), j.pos_table())
    chunks = list(t.iter_pair_chunks(capacity=64))
    jchunks = list(j.iter_pair_chunks(capacity=64))
    assert [c.shape[0] for c in chunks] == [c.shape[0] for c in jchunks]
    if chunks:
        assert_rows(torch.cat(chunks), np.concatenate(jchunks))


@pytest.mark.parametrize("name,k", CASES)
def test_lookups_equal_jax_and_single(meshes, name, k):
    """lookup_counts and positions_of (max_hits_per_shard = 64: several
    drains where a key repeats) on every window's key of the sequence plus
    keys absent from it."""
    j, t, one = built(meshes, name, k)
    raw = np.unique(raw_np(one.s_key[: one.n_valid]))
    absent = np.array([0, 2 ** 63 - 1, 2 ** 64 - 1], np.uint64)
    if k < 32:
        absent = absent & np.uint64((1 << (2 * k)) - 1)
    q = np.concatenate([raw, absent])
    hi, lo = (q >> np.uint64(32)).astype(np.uint32), q.astype(np.uint32)
    got = t.lookup_counts(to_raw_i64(q))
    assert_rows(got, j.lookup_counts(hi, lo))
    lb, ub = one.lookup_range(to_raw_i64(q))
    assert torch.equal(got.long(), ub - lb)
    for sel in (slice(0, 1), slice(None)):
        pos = t.positions_of(to_raw_i64(q[sel]), max_hits_per_shard=64)
        assert_rows(pos, j.positions_of(hi[sel], lo[sel],
                                        max_hits_per_shard=64))
        lb, ub = one.lookup_range(to_raw_i64(q[sel]))
        want = torch.cat([one.s_pos[a:b] for a, b in
                          zip(lb.tolist(), ub.tolist())])
        assert torch.equal(pos, torch.sort(want).values)


def check_blocks(blocks, jblocks, C):
    assert len(blocks) == len(jblocks)
    for b, jb in zip(blocks, jblocks):
        assert_rows(b, jb)
        assert b.shape[0] <= 3 * D * C


@pytest.mark.parametrize("name,k", [c for c in CASES if c[1] <= 31])
def test_seq_kmer_pos_equals_jax_and_single(meshes, name, k):
    j, t, one = built(meshes, name, k)
    seq = INPUTS[name](k)
    query = np.concatenate([seq[100:700], np.frombuffer(b"N", np.uint8),
                            seq[1450:1900]]) if name != "short" else seq
    C = 64
    blocks = list(t.iter_seq_kmer_pos(query, k, max_hits_per_shard=C))
    check_blocks(blocks, list(j.iter_seq_kmer_pos(
        query, k, max_hits_per_shard=C)), C)
    assert t._merge_peak_rows <= 3 * D * C
    got = t.seq_kmer_pos(query, k)
    assert_rows(got, j.seq_kmer_pos(query, k))
    assert torch.equal(got, seq_kmer_pos(one, query, k))
    assert torch.equal(torch.cat(blocks), got)


def test_repeat_rich_streams_stay_bounded(meshes):
    """One hyper-repeated k-mer in one shard: queries drain in many chunks
    of 64, blocks ascend, buffers stay under 3*D*C rows, and the
    cross-index pairs stream in the single index's order."""
    k, C = 5, 64
    jm, tm = meshes
    t, j = ShardedKmerIndex(REPEAT, k, tm), JShardedKmerIndex(REPEAT, k, jm)
    one = KmerIndex(REPEAT, k, device=CPU)
    query = REPEAT[:80]
    blocks = list(t.iter_seq_kmer_pos(query, k, max_hits_per_shard=C))
    check_blocks(blocks, list(j.iter_seq_kmer_pos(
        query, k, max_hits_per_shard=C)), C)
    assert len(blocks) > 1 and t._merge_peak_rows <= 3 * D * C
    keys = tsp._row_keys(torch.cat(blocks))
    assert bool((keys[1:] >= keys[:-1]).all())
    assert torch.equal(torch.cat(blocks), seq_kmer_pos(one, query, k))
    q = enc.encode_stream(torch.frombuffer(bytearray(b"ACTGGACT"),
                                           dtype=torch.uint8), k, 8)[0][:1]
    hi, lo = enc.split_hi_lo(q)
    pos = t.positions_of(q, max_hits_per_shard=16)
    assert pos.shape[0] > 16 * 4
    assert_rows(pos, j.positions_of(hi.numpy().astype(np.uint32),
                                    lo.numpy().astype(np.uint32),
                                    max_hits_per_shard=16))
    sb = "ACTGG" * 40 + "A" + "ACGTACGTAA" * 10
    tb, jb = ShardedKmerIndex(sb, k, tm), JShardedKmerIndex(sb, k, jm)
    want = kmer_pairs(one, KmerIndex(sb, k, device=CPU))
    assert want.shape[0] > D * C
    pblocks = list(iter_kmer_pairs_sharded_chunks(t, tb, capacity=C))
    assert tsp._PAIRS_STREAM_STATS["peak_rows"] <= 3 * D * C
    jblocks = list(jiter(j, jb, capacity=C))
    assert jsp._PAIRS_STREAM_STATS["peak_rows"] == \
        tsp._PAIRS_STREAM_STATS["peak_rows"]
    assert len(pblocks) == len(jblocks) > 1
    assert max(b.shape[0] for b in pblocks) <= C
    for b, jblk in zip(pblocks, jblocks):
        assert_rows(b, jblk)
    assert torch.equal(torch.cat(pblocks), want)
    got = kmer_pairs_sharded(t, tb)
    assert torch.equal(got, want)
    assert_rows(got, jkmer_pairs_sh(j, jb))
    with pytest.raises(MemoryError, match="max_pairs"):
        kmer_pairs_sharded(t, tb, max_pairs=want.shape[0] - 1)
    assert kmer_pairs_sharded(t, tb, max_pairs=want.shape[0]).shape == \
        want.shape


@pytest.mark.parametrize("k", (5, 21, 32))
def test_kmer_pairs_sharded_equals_jax_and_single(meshes, k):
    j, t, one = built(meshes, "mixed", k)
    seq = mixed_seq()
    jb, tb, ob = built(meshes, "quirk", k)
    want = kmer_pairs(one, ob)
    got = kmer_pairs_sharded(t, tb)
    assert torch.equal(got, want)
    assert_rows(got, jkmer_pairs_sh(j, jb))
    assert_rows(got, jkmer_pairs(JKmerIndex(seq, k), JKmerIndex(
        quirk_seq(k), k)))
    assert torch.equal(torch.cat(list(iter_kmer_pairs_sharded_chunks(
        t, tb, capacity=64))), want)


@pytest.mark.parametrize("k", (21, 32))
def test_halo_longer_than_a_chunk(meshes, k):
    """40 bases on 8 shards at k > 17: each chunk's row reaches past its
    right neighbour; the tables and lookups are the single index's."""
    _, tm = meshes
    seq = short_seq()
    t, one = ShardedKmerIndex(seq, k, tm), KmerIndex(seq, k, device=CPU)
    assert t.chunk == 16 and t.total_kmers == one.n_valid > 0
    got, want = t.tables(15), one.tables(15)
    assert got["kmer"] == want["kmer"]
    for f in ("pos", "pair.pos", "count"):
        assert torch.equal(got[f], want[f]), f
    q = one.s_key[: one.n_valid] ^ enc.SIGN
    lb, ub = one.lookup_range(q)
    assert torch.equal(t.lookup_counts(q).long(), ub - lb)
    assert torch.equal(t.positions_of(q), torch.sort(one.s_pos[
        : one.n_valid]).values)
    if k <= 31:
        assert torch.equal(t.seq_kmer_pos(seq, k), seq_kmer_pos(one, seq, k))


def test_kmer_pairs_sharded_with_no_rows(meshes):
    """Two indexes with no k-mer in common: the iterator yields one empty
    (0, 2) block, as the single-device iterator does."""
    k = 21
    _, tm = meshes
    a = ShardedKmerIndex("A" * 30 + "C" * 30, k, tm)
    b = ShardedKmerIndex("G" * 30 + "T" * 30, k, tm)
    blocks = list(iter_kmer_pairs_sharded_chunks(a, b))
    assert len(blocks) == 1 and blocks[0].shape == (0, 2)
    assert blocks[0].dtype == torch.int32
    assert kmer_pairs_sharded(a, b).shape == (0, 2)
    assert tsp._PAIRS_STREAM_STATS["peak_rows"] == 0
    assert a.seq_kmer_pos("G" * 30, k).shape == (0, 2)


def test_errors(meshes):
    _, tm = meshes
    with pytest.raises(ValueError, match="k must be"):
        ShardedKmerIndex("ACGT" * 20, 33, tm)
    with pytest.raises(ValueError, match="k must be"):
        ShardedKmerIndex("ACGT" * 20, 0, tm)
    with pytest.raises(ValueError, match="at least k"):
        ShardedKmerIndex("ACGTA", 5, tm)
    a = ShardedKmerIndex("ACGTTGCA" * 10, 5, tm)
    with pytest.raises(ValueError, match="k mismatch"):
        kmer_pairs_sharded(a, ShardedKmerIndex("ACGTTGCA" * 10, 6, tm))
    with pytest.raises(ValueError, match="same mesh"):
        kmer_pairs_sharded(a, ShardedKmerIndex("ACGTTGCA" * 10, 5,
                                               make_mesh(4, device=CPU)))
    # another group of the same layout on the same device is the same mesh
    same = ShardedKmerIndex("ACGTTGCA" * 10, 5, make_mesh(D, device=CPU))
    assert kmer_pairs_sharded(a, same).shape[0] > 0
    with pytest.raises(ValueError, match="should not be longer than 31"):
        a.seq_kmer_pos("ACGT" * 20, 32)
    with pytest.raises(ValueError, match="longer than k"):
        a.seq_kmer_pos("ACGTA", 5)


def test_drop_range_partition_and_rebuild(meshes):
    _, t, _ = built(meshes, "mixed", 21)
    before = t.tables(15)
    assert t._rp is not None and t._rp_stats is not None
    t.drop_range_partition()
    assert t._rp is None and t._rp_spl is None and t._rp_stats is None
    after = t.tables(15)
    assert after["kmer"] == before["kmer"]
    for f in ("pos", "pair.pos", "count"):
        assert torch.equal(after[f], before[f])


@pytest.mark.parametrize("k", (1, 21, 32))
def test_build_rows_past_the_end_are_all_invalid(k):
    """The build's batch on the CPU (B1's plain version): 40 bases in 8
    chunks of 16, so rows 3..7 have lengths of zero or less and rows 1..2
    reach into the N padding; the valid windows are the single sequence's,
    by their global starts."""
    seq = short_seq()
    rows, lengths = tsp.chunk_rows(torch.from_numpy(seq), D, 16, k, CPU)
    halo = max(1, k - 1)
    assert rows.shape == (D, 16 + halo) and lengths.dtype == np.int32
    np.testing.assert_array_equal(lengths, np.minimum(
        40 - 16 * np.arange(D), 16 + halo))
    assert (lengths <= 0).sum() == 5
    _, valid = enc.encode_stream(rows, k, lengths)
    assert not valid[3:].any()
    starts = (torch.nonzero(valid[:, :16]) * torch.tensor([16, 1])).sum(1)
    want = enc.window_valid(torch.from_numpy(seq), k, 40)
    assert torch.equal(starts, torch.nonzero(want).squeeze(1))


@pytest.mark.parametrize("n_shards", (1, 2, 3, 5, 7, 16))
def test_other_shard_counts_equal_single(n_shards):
    """Groups of other sizes than 8, odd ones too (chunks of 2^12 down to
    2^8 bases, shards past the end at 16): tables(15), seq_kmer_pos in
    blocks of 64 hits a shard and kmer_pairs_sharded equal the single
    index's."""
    mesh = make_mesh(n_shards, device=CPU)
    seq, other = mixed_seq(), quirk_seq(21)
    for k in (5, 21):
        t, one = ShardedKmerIndex(seq, k, mesh), KmerIndex(seq, k, device=CPU)
        assert t.n_valid.shape == (n_shards,)
        got, want = t.tables(15), one.tables(15)
        assert got["kmer"] == want["kmer"]
        for f in ("pos", "pair.pos", "count"):
            assert torch.equal(got[f], want[f]), f
        query = np.concatenate([seq[100:700], np.frombuffer(b"N", np.uint8),
                                seq[1450:1900]])
        assert torch.equal(t.seq_kmer_pos(query, k, max_hits_per_shard=64),
                           seq_kmer_pos(one, query, k))
        b = ShardedKmerIndex(other, k, mesh)
        assert torch.equal(kmer_pairs_sharded(t, b, capacity=64), kmer_pairs(
            one, KmerIndex(other, k, device=CPU)))
