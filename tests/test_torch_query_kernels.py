"""The host side of the card's query path (Q1, Q2 in ``ops/cuda_query.py``)
on the CPU: the trailing-exact-k window found from the host's bytes
against ``drop_trailing_mask``, the kernels' plain versions against the
query's plain path, and ``seq_kmer_pos``'s lone and concatenated chunks
against the JAX package. The kernels themselves run in
``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.index import query as tq
from kmer_hasher_tpu_torch.ops import cuda_encode, cuda_query
from kmer_hasher_tpu_torch.ops import encode as enc

TRAILING = [(k, n) for k in (1, 16, 21, 31) for n in range(k + 1, 3 * k + 1)]


@pytest.mark.parametrize("k,n", TRAILING)
def test_trailing_drop_matches_the_mask(k, n):
    """One N at every offset of the last 2k bases, and none: the host's
    index of the dropped window is the one place the mask is False."""
    rng = np.random.default_rng(1000 * k + n)
    base = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=n)
    for at in [None, *range(max(0, n - 2 * k), n)]:
        seq = base.copy()
        if at is not None:
            seq[at] = ord("N" if at % 2 else "n")
        mask = enc.drop_trailing_mask(torch.from_numpy(seq), k, n)
        want = torch.nonzero(~mask).flatten().tolist()
        got = cuda_query.trailing_drop(seq, k, n)
        assert want == ([] if got < 0 else [got]), (at, want, got)


def ref_and_query(seed, L=6000):
    # 6,000 bases: the JAX package caches its jitted index build by shape
    # and reads its sort route's switch when it traces, so this file keeps
    # to a shape of its own
    rng = np.random.default_rng(seed)
    ref = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=L)
    unit = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=50)
    ref[1000:1000 + 50 * 12] = np.tile(unit, 12)  # a tandem repeat
    for a in rng.integers(0, L - 60, size=6):
        ref[a: a + int(rng.integers(1, 40))] = ord("N")
    qry = ref[800:2200].copy()
    sub = rng.random(qry.shape[0]) < 0.01
    qry[sub] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                          size=int(sub.sum()))
    return ref, qry


@pytest.mark.parametrize("k", [1, 15, 16, 17, 21, 31])
def test_plain_versions_match_the_query_path(k):
    """Q1's and Q2's plain versions, the wrappers' CPU route, give the
    numbers of ``_query_ranges`` and ``_hit_chunk``, chunk by chunk, with
    the quirk's window just before the end."""
    ref, qry = ref_and_query(k)
    if k == 1:
        qry = qry[:60].copy()
    qry[-k - 1] = ord("N")
    idx = api.make_kmer_hash(ref, k, device="cpu")
    assert idx.s_key.shape[0] > idx.n_valid
    n = qry.shape[0]
    x = torch.from_numpy(qry)
    lb0, c0, cum0 = tq._query_ranges(idx.s_key, idx.n_valid, x, k, n)
    key, valid = cuda_encode.encode(x, k, n)
    drop = cuda_query.trailing_drop(qry, k, n)
    assert drop == n - k
    lb, c = cuda_query.ranges(key, valid, idx.s_key, idx.n_valid, drop)
    assert torch.equal(lb, lb0) and torch.equal(c, c0)
    total = int(cum0[-1])
    assert total > 0
    for start in range(0, total, 100):
        m = min(100, total - start)
        assert torch.equal(
            cuda_query.hits(idx.s_pos, lb, c, cum0, k, start, m),
            tq._hit_chunk(idx.s_pos, lb0, c0, cum0, k, start, m))


def test_wrappers_refuse_what_they_do_not_take():
    key = torch.zeros(8, dtype=torch.int64)
    valid = torch.ones(8, dtype=torch.bool)
    s_key = torch.zeros(16, dtype=torch.int64)
    with pytest.raises(TypeError):
        cuda_query.ranges(key.int(), valid, s_key, 4, -1)
    with pytest.raises(ValueError):
        cuda_query.ranges(key, valid[:4], s_key, 4, -1)
    with pytest.raises(ValueError):
        cuda_query.ranges(key, valid, s_key, 17, -1)
    pos = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_query.hits(pos.long(), key, key, key, 4, 0, 1)
    with pytest.raises(ValueError):
        cuda_query.hits(pos, key, key, key[:4], 4, 0, 1)


def hit_matrix_is(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.dim() == 2 and got.shape[1] == 2
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [16, 21])
def test_seq_kmer_pos_gives_the_lone_chunk_as_it_is(k, monkeypatch):
    ref, qry = ref_and_query(40 + k)
    idx = api.make_kmer_hash(ref, k, device="cpu")
    made, cats = [], []
    chunk = tq._hit_chunk
    cat = torch.cat
    monkeypatch.setattr(tq, "_hit_chunk",
                        lambda *a: made.append(chunk(*a)) or made[-1])
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **kw: cats.append(1) or cat(*a, **kw))
    got = api.seq_kmer_pos(idx, qry, k)
    assert len(made) == 1 and not cats
    assert got.data_ptr() == made[0].data_ptr()
    hit_matrix_is(got, japi.seq_kmer_pos(japi.make_kmer_hash(ref, k), qry, k))


@pytest.mark.parametrize("k", [16, 21])
def test_seq_kmer_pos_concatenates_several_chunks(k, monkeypatch):
    ref, qry = ref_and_query(50 + k)
    idx = api.make_kmer_hash(ref, k, device="cpu")
    chunks = list(api.iter_seq_kmer_pos_chunks(idx, qry, k, capacity=64))
    assert len(chunks) > 1
    drain = tq.iter_seq_kmer_pos_chunks
    monkeypatch.setattr(tq, "iter_seq_kmer_pos_chunks",
                        lambda index, query, k, capacity: drain(
                            index, query, k, 64))
    got = api.seq_kmer_pos(idx, qry, k)
    assert torch.equal(got, torch.cat(chunks))
    hit_matrix_is(got, japi.seq_kmer_pos(japi.make_kmer_hash(ref, k), qry, k))
