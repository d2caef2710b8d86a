"""Port queries (PyTorch, CPU) vs the JAX package and the refsem oracle:
seq.kmer.pos and kmer.pairs rows in reference order, exact equality."""
import numpy as np
import pytest
import torch

from kmer_hasher_tpu import refsem as rs
from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.index import query as tq
from kmer_hasher_tpu_torch.utils.checkpoint import index_from_numpy


def random_str(rng, L, alphabet="ACGTacgtN",
               p=(.12, .12, .12, .12, .12, .12, .12, .12, .04)):
    return "".join(rng.choice(list(alphabet), size=L, p=p))


def ref_and_query(seed, L=2000):
    rng = np.random.default_rng(seed)
    ref = random_str(rng, L)
    ref = ref[:1500] + ref[200:500]  # a repeat inside the indexed sequence
    qry = random_str(rng, 400)
    # splice indexed chunks (and a lower-cased one) into the query
    qry = (qry[:100] + ref[50:190] + qry[100:200] + ref[1200:1400].lower()
           + "N" + qry[200:] + ref[-60:])
    return ref, qry


@pytest.mark.parametrize("k", [4, 16, 21, 31])
def test_seq_kmer_pos_matches_jax_and_refsem(k):
    ref, qry = ref_and_query(k)
    got = api.seq_kmer_pos(api.make_kmer_hash(ref, k, device="cpu"), qry,
                           k).numpy()
    want = rs.seq_kmer_positions(rs.make_kmer_hash(ref, k), qry, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, japi.seq_kmer_pos(japi.make_kmer_hash(ref, k), qry, k))
    assert len(got) > 50


def test_query_chunks_concatenate_to_full():
    k = 12
    ref, qry = ref_and_query(5)
    idx = api.make_kmer_hash(ref, k, device="cpu")
    chunks = list(api.iter_seq_kmer_pos_chunks(idx, qry, k, capacity=64))
    full = api.seq_kmer_pos(idx, qry, k)
    assert len(chunks) > 1
    assert torch.equal(torch.cat(chunks), full)


def test_query_on_jax_built_index():
    # a JAX-built index handed to the port's query code as numpy arrays
    k = 21
    ref, qry = ref_and_query(9)
    j = japi.make_kmer_hash(ref, k)
    t = index_from_numpy(j.k, j.seq_len, np.asarray(j.s_hi),
                         np.asarray(j.s_lo), np.asarray(j.s_pos), j.n_valid,
                         device="cpu")
    np.testing.assert_array_equal(api.seq_kmer_pos(t, qry, k).numpy(),
                                  japi.seq_kmer_pos(j, qry, k))
    np.testing.assert_array_equal(api.kmer_pos(t, 2)["pos"].numpy(),
                                  j.tables(2)["pos"])


def test_query_validation_and_no_hits():
    idx = api.make_kmer_hash("ACGT" * 30, 10, device="cpu")
    with pytest.raises(ValueError):
        api.seq_kmer_pos(idx, "ACGT" * 20, 32)
    with pytest.raises(ValueError):
        api.seq_kmer_pos(idx, "ACGTACGT", 10)
    got = api.seq_kmer_pos(idx, "G" * 20, 10)
    assert got.shape == (0, 2) and got.dtype == torch.int32


@pytest.mark.parametrize("k", [9, 32])
def test_kmer_pairs_matches_jax_and_refsem(k):
    rng = np.random.default_rng(70 + k)
    sa = random_str(rng, 600)
    sb = sa[100:350] + random_str(rng, 200) + sa[400:500]
    ta = api.make_kmer_hash(sa, k, device="cpu")
    tb = api.make_kmer_hash(sb, k, device="cpu")
    got = api.kmer_pairs(ta, tb).numpy()
    want = rs.kmer_pair_pos(rs.make_kmer_hash(sa, k),
                            rs.make_kmer_hash(sb, k))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, japi.kmer_pairs(
        japi.make_kmer_hash(sa, k), japi.make_kmer_hash(sb, k)))
    assert tq.kmer_pairs_total(ta, tb) == len(got) > 100
    chunks = list(api.iter_kmer_pairs_chunks(ta, tb, capacity=32))
    assert len(chunks) > 1 and torch.equal(torch.cat(chunks),
                                           torch.from_numpy(got))
    with pytest.raises(MemoryError):
        api.kmer_pairs(ta, tb, max_pairs=10)


def test_kmer_pairs_disjoint():
    a = api.make_kmer_hash("A" * 50, 8, device="cpu")
    b = api.make_kmer_hash("C" * 50, 8, device="cpu")
    assert api.kmer_pairs(a, b).shape == (0, 2)
    assert tq.kmer_pairs_total(a, b) == 0
