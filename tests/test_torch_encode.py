"""Port encode (PyTorch, CPU plain path) vs the JAX package: encode_stream
and the Pallas kernel B1 in interpret mode. Every output is an integer, so
the tolerance is exact, bitwise equality."""
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.ops import encode as jenc
from kmer_hasher_tpu.ops.pallas_encode import pallas_encode, pallas_encode_batch
from kmer_hasher_tpu_torch.ops import cuda_encode
from kmer_hasher_tpu_torch.ops import encode as tenc

KS = [1, 4, 16, 17, 31, 32]


def random_seq(rng, L, n_runs=4):
    """Mixed-case bases with a few N runs (lengths 1..40)."""
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=L)
    for _ in range(n_runs):
        a = int(rng.integers(0, L))
        seq[a: a + int(rng.integers(1, 41))] = ord("N")
    return seq


def raw_from_jax(hi, lo):
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).view(np.int64)


def batch(rng, k, B=12, L=256):
    seq = np.stack([random_seq(rng, L, n_runs=1) for _ in range(B)])
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[0] = L  # full row: windows crossing into the next row
    lengths[1] = 0
    lengths[2] = k  # exactly one window
    return seq, lengths


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("k", KS)
def test_encode_stream_matches_jax(k, drop):
    rng = np.random.default_rng(100 + k)
    L = 1000
    seq = random_seq(rng, L)
    seq[L - 7 - k - 1] = ord("N")  # exact-k tail region: the quirk fires
    true_len = L - 7
    hi, lo, v = jenc.encode_stream(seq, k, true_len,
                                   drop_trailing_exact_k=drop)
    key, valid = tenc.encode_stream(torch.from_numpy(seq), k, true_len,
                                    drop_trailing_exact_k=drop)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(v))
    np.testing.assert_array_equal(key.numpy(), raw_from_jax(hi, lo))
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("k", [4, 21, 32])
def test_encode_stream_batch_matches_jax(k):
    rng = np.random.default_rng(200 + k)
    seq, lengths = batch(rng, k)
    for drop in (False, True):
        hi, lo, v = jenc.encode_stream(seq, k, lengths,
                                       drop_trailing_exact_k=drop)
        key, valid = tenc.encode_stream(
            torch.from_numpy(seq), k, torch.from_numpy(lengths),
            drop_trailing_exact_k=drop)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(v))
        np.testing.assert_array_equal(key.numpy(), raw_from_jax(hi, lo))


@pytest.mark.parametrize("k", KS)
def test_b1_plain_matches_pallas_interpret(k):
    # the Pallas kernel leaves garbage at invalid starts: compare validity
    # everywhere, keys where valid
    rng = np.random.default_rng(300 + k)
    L = 1000
    seq = random_seq(rng, L)
    true_len = L - 7
    hi, lo, v = pallas_encode(seq, k, true_len, interpret=True)
    key, valid = cuda_encode.encode(torch.from_numpy(seq), k, true_len)
    v = np.asarray(v)
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_array_equal(key.numpy()[v], raw_from_jax(hi, lo)[v])


@pytest.mark.parametrize("k", [4, 21, 32])
def test_b1_plain_batch_matches_pallas_interpret(k):
    rng = np.random.default_rng(400 + k)
    seq, lengths = batch(rng, k)
    hi, lo, v = pallas_encode_batch(seq, k, lengths, interpret=True)
    key, valid = cuda_encode.encode(torch.from_numpy(seq), k,
                                    torch.from_numpy(lengths))
    v = np.asarray(v)
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_array_equal(key.numpy()[v], raw_from_jax(hi, lo)[v])


@pytest.mark.parametrize("k", [1, 5, 16, 17, 21, 31, 32])
def test_revcomp_and_canonical_match_jax(k):
    rng = np.random.default_rng(400 + k)
    L = 600
    seq = random_seq(rng, L)
    seq[100:100 + 40] = ord("G")  # all-G windows: bit 63 at k=32, rc = all-C
    hi, lo, v = jenc.encode_stream(seq, k, L)
    rhi, rlo = jenc.revcomp_windows(hi, lo, k)
    raw = torch.from_numpy(raw_from_jax(hi, lo))
    rc = tenc.revcomp_windows(raw, k)
    np.testing.assert_array_equal(rc.numpy(), raw_from_jax(rhi, rlo))
    chi, clo = jenc.canonical_windows(hi, lo, rhi, rlo)
    np.testing.assert_array_equal(tenc.canonical_windows(raw, rc).numpy(),
                                  raw_from_jax(chi, clo))
    # the stream entry, 1-D and batched
    hi, lo, v = jenc.encode_stream(seq, k, L - 5, canonical=True)
    key, valid = tenc.encode_stream(torch.from_numpy(seq), k, L - 5,
                                    canonical=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(v))
    np.testing.assert_array_equal(key.numpy(), raw_from_jax(hi, lo))
    seq2, lens = batch(rng, k, B=6)
    hi, lo, v = jenc.encode_stream(seq2, k, lens, canonical=True)
    key, valid = tenc.encode_stream(torch.from_numpy(seq2), k,
                                    torch.from_numpy(lens), canonical=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(v))
    np.testing.assert_array_equal(key.numpy(), raw_from_jax(hi, lo))


@pytest.mark.parametrize("k", [4, 21])
def test_drop_trailing_mask_matches_jax(k):
    rng = np.random.default_rng(500 + k)
    L = 256
    seq = random_seq(rng, L)
    for tl in (L, L - 3, k, k - 1, 0):
        want = np.asarray(jenc.drop_trailing_mask(seq, k, tl))
        got = tenc.drop_trailing_mask(torch.from_numpy(seq), k, tl)
        np.testing.assert_array_equal(got.numpy(), want)
    seq2, lens = batch(rng, k, B=8)
    want = np.asarray(jenc.drop_trailing_mask(seq2, k, lens))
    got = tenc.drop_trailing_mask(torch.from_numpy(seq2), k,
                                  torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensor_takes_plain_path():
    # the wrapper gives way to the plain version only for a CPU tensor,
    # and a plain run is no launch
    rng = np.random.default_rng(7)
    seq = torch.from_numpy(random_seq(rng, 300))
    before = cuda_encode.encode.launches
    key, valid = cuda_encode.encode(seq, 21, 290)
    pk, pv = cuda_encode.plain(seq, 21, 290)
    assert cuda_encode.encode.launches == before
    assert torch.equal(key, pk) and torch.equal(valid, pv)
    tenc.encode_stream(seq, 21, 290, drop_trailing_exact_k=True)
    assert cuda_encode.encode.launches == before


def test_b1_wrapper_rejects_bad_input():
    seq = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_encode.encode(seq, 0, 100)
    with pytest.raises(ValueError):
        cuda_encode.encode(seq, 33, 100)
    with pytest.raises(TypeError):
        cuda_encode.encode(seq.to(torch.int32), 4, 100)
    with pytest.raises(ValueError):
        cuda_encode.encode(seq.reshape(2, 5, 10), 4, 100)
    with pytest.raises(ValueError):
        cuda_encode.encode(seq.to("meta"), 4, 100)


def test_sortable_key_orders_unsigned():
    raw = torch.tensor([0, 1, (1 << 63) - 1, -(1 << 63), -2, -1])
    order = torch.argsort(tenc.sortable_key(raw))
    assert order.tolist() == list(range(6))
    assert torch.equal(tenc.sortable_key(tenc.sortable_key(raw)), raw)
    hi, lo = tenc.split_hi_lo(raw)
    assert hi.tolist()[-1] == lo.tolist()[-1] == 0xFFFFFFFF
