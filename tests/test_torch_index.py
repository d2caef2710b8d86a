"""Port position index (PyTorch, CPU) vs the JAX package and the refsem
oracle: sorted arrays over the full window axis, the kmer.pos tables, the
streamed pair table and build_many. Exact, bitwise equality throughout."""
import numpy as np
import pytest
import torch

from kmer_hasher_tpu import refsem as rs
from kmer_hasher_tpu.index import KmerIndex as JaxIndex
from kmer_hasher_tpu.index import position_index as jpix
from kmer_hasher_tpu_torch.index import KmerIndex
from kmer_hasher_tpu_torch.index import position_index as tpix


def random_seq(rng, L, n_runs=4):
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=L)
    for _ in range(n_runs):
        a = int(rng.integers(0, L))
        seq[a: a + int(rng.integers(1, 41))] = ord("N")
    return seq


def repeat_seq(seed, L=2000):
    """~2 kb with N runs and two planted repeats, so k-mers recur and the
    pair table has real multi-row segments."""
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, L)
    seq[1200:1500] = seq[100:400]
    seq[1600:1690] = np.frombuffer(b"ACGTTG" * 15, np.uint8)
    return seq


def assert_same_index(t, j):
    """Port index arrays == JAX index arrays over the whole window axis."""
    assert t.n_valid == j.n_valid and t.seq_len == j.seq_len
    np.testing.assert_array_equal(t.s_hi.numpy(), np.asarray(j.s_hi))
    np.testing.assert_array_equal(t.s_lo.numpy(), np.asarray(j.s_lo))
    for name in ("s_pos", "starts", "seg_ids", "i_col", "m", "cum_m"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


def assert_same_tables(got, want):
    assert got["kmer"] == want["kmer"]
    for f in ("pos", "pair.pos", "count"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]), f)


@pytest.mark.parametrize("k", [5, 16, 21, 31, 32])
def test_build_index_arrays_matches_jax(k):
    rng = np.random.default_rng(k)
    L = 1024
    seq = random_seq(rng, L)
    tl = L - 9
    want = jpix.build_index_arrays(seq, k, tl)
    s_key, s_pos, n_valid, starts, seg_ids = tpix.build_index_arrays(
        torch.from_numpy(seq), k, tl)
    raw = s_key ^ torch.iinfo(torch.int64).min
    np.testing.assert_array_equal(((raw >> 32) & 0xFFFFFFFF).numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal((raw & 0xFFFFFFFF).numpy(),
                                  np.asarray(want[1]))
    for got, w in zip((s_pos, n_valid, starts, seg_ids), want[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [16, 32])
def test_build_index_arrays_batch_matches_jax(k):
    rng = np.random.default_rng(40 + k)
    seq = np.stack([random_seq(rng, 128, 1) for _ in range(4)])
    lens = np.array([128, 0, k + 1, 77], np.int64)
    want = jpix.build_index_arrays(seq, k, lens)
    got = tpix.build_index_arrays(torch.from_numpy(seq), k,
                                  torch.from_numpy(lens))
    raw = got[0] ^ torch.iinfo(torch.int64).min
    np.testing.assert_array_equal(((raw >> 32) & 0xFFFFFFFF).numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal((raw & 0xFFFFFFFF).numpy(),
                                  np.asarray(want[1]))
    for g, w in zip(got[1:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k,seq", [
    # 32 Gs: real all-ones keys share the invalid sentinel (two-key sort)
    (32, "G" * 40 + "A" + "G" * 35 + "N" + "ACGT" * 3),
    # 16 Gs: an all-ones high word beside the packed sentinel
    (16, "G" * 20 + "A" + "G" * 17 + "N" + "ACGT" * 4),
])
def test_all_g_kmers_with_invalid_tail(k, seq):
    t, j = KmerIndex(seq, k, device="cpu"), JaxIndex(seq, k)
    assert_same_index(t, j)
    want = rs.kmer_positions(rs.make_kmer_hash(seq, k), 15)
    assert_same_tables(t.tables(15), want)
    assert t.counts().max() > 1  # the degenerate all-G k-mer repeats


@pytest.mark.parametrize("k", [5, 16, 21, 31, 32])
def test_tables_match_jax_and_refsem(k):
    seq = repeat_seq(k)
    t, j = KmerIndex(seq, k, device="cpu"), JaxIndex(seq, k)
    assert_same_index(t, j)
    got = t.tables(15)
    assert_same_tables(got, j.tables(15))
    want = rs.kmer_positions(rs.make_kmer_hash(seq.tobytes().decode(), k), 15)
    assert_same_tables(got, want)
    assert t.n_kmers == j.n_kmers and t.total_pairs == j.total_pairs


@pytest.mark.parametrize("k", [8, 21])
def test_pair_chunks_multichunk_match_jax(k):
    # a 97-base unit 12 times in tandem: ~66 pairs per k-mer, several chunks
    rng = np.random.default_rng(50 + k)
    seq = np.concatenate([random_seq(rng, 300, 1),
                          np.tile(random_seq(rng, 97, 0), 12),
                          random_seq(rng, 200, 1)])
    t, j = KmerIndex(seq, k, device="cpu"), JaxIndex(seq, k)
    chunks = list(t.iter_pair_chunks(capacity=1024))
    assert len(chunks) > 1 and all(len(c) <= 1024 for c in chunks)
    got = torch.cat(chunks).numpy()
    np.testing.assert_array_equal(got, j.pair_table())
    np.testing.assert_array_equal(t.pair_table().numpy(), got)
    assert len(got) == t.total_pairs


def test_build_many_matches_individual_and_jax():
    k = 9
    base = repeat_seq(3)
    seqs = [base[:500], base[500:1700], base[1700:1764], base[:300],
            "ACTG" * 40 + "N" + "GGATC" * 30, base[1000:1400]]
    many = KmerIndex.build_many(seqs, k, device="cpu")
    jmany = JaxIndex.build_many(seqs, k)
    assert len(many) == len(seqs)
    for s, ix, jx in zip(seqs, many, jmany):
        one = KmerIndex(s, k, device="cpu")
        assert torch.equal(ix.s_key, one.s_key)
        assert_same_tables(ix.tables(15), jx.tables(15))


def test_validation_errors():
    with pytest.raises(ValueError):
        KmerIndex("ACGT", 0, device="cpu")
    with pytest.raises(ValueError):
        KmerIndex("ACGT", 33, device="cpu")
    with pytest.raises(ValueError):
        KmerIndex("ACGT", 4, device="cpu")
    with pytest.raises(ValueError):
        KmerIndex(np.zeros((2, 40), np.uint8), 4, device="cpu")
    with pytest.raises(ValueError):
        KmerIndex.build_many(["ACGTACGT", "ACG"], 4, device="cpu")
    with pytest.raises(ValueError):
        KmerIndex.build_many(["ACGTACGT"], 40, device="cpu")
    with pytest.raises(MemoryError):
        KmerIndex("A" * 100, 4, device="cpu").pair_table(max_pairs=10)


def test_cuda_device_without_card_raises():
    # a CUDA request never falls back to the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        KmerIndex("ACGT" * 20, 5, device="cuda")


def test_index_without_valid_windows():
    # no valid window at all: empty tables, same arrays as the JAX package
    seq = "NNNNACGNNNNNNNNNNNNNNNNN"
    t, j = KmerIndex(seq, 4, device="cpu"), JaxIndex(seq, 4)
    assert t.n_valid == 0 and t.total_pairs == 0
    assert_same_index(t, j)
    tabs = t.tables(15)
    assert tabs["kmer"] == [] and tabs["pair.pos"].shape == (0, 3)
