"""Checkpoints across packages: an index or a count store saved by either
package loads in the other and answers the same queries, exactly; a
sharded store's file loads into the port's single store whole."""
import json

import numpy as np
import pytest

from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt


def sequence(seed=1, L=1500):
    rng = np.random.default_rng(seed)
    seq = rng.choice(list("ACGTN"), size=L, p=[.24, .24, .24, .24, .04])
    s = "".join(seq)
    return s[:1000] + s[300:500] + s[1000:]


def assert_same_answers(t, j, query, k):
    tt, jt = api.kmer_pos(t, 15), japi.kmer_pos(j, 15)
    assert tt["kmer"] == jt["kmer"]
    for f in ("pos", "pair.pos", "count"):
        np.testing.assert_array_equal(tt[f].numpy(), np.asarray(jt[f]), f)
    np.testing.assert_array_equal(api.seq_kmer_pos(t, query, k).numpy(),
                                  japi.seq_kmer_pos(j, query, k))


@pytest.mark.parametrize("k", [10, 21])
def test_port_npz_loads_in_jax(tmp_path, k):
    seq = sequence(k)
    t = api.make_kmer_hash(seq, k, device="cpu")
    p = tmp_path / "port.npz"
    tckpt.save_index(t, p)
    j = jckpt.load_index(p)
    assert (j.k, j.seq_len, j.n_valid) == (t.k, t.seq_len, t.n_valid)
    assert_same_answers(t, j, seq[250:700], k)


@pytest.mark.parametrize("k", [10, 21])
def test_jax_npz_loads_in_port(tmp_path, k):
    seq = sequence(k + 1)
    j = japi.make_kmer_hash(seq, k)
    p = tmp_path / "jax.npz"
    jckpt.save_index(j, p)
    t = tckpt.load_index(p, device="cpu")
    assert (t.k, t.seq_len, t.n_valid) == (j.k, j.seq_len, j.n_valid)
    assert_same_answers(t, j, seq[250:700], k)
    # the port reloads its own save of the restored index unchanged
    p2 = tmp_path / "again.npz"
    tckpt.save_index(t, p2)
    with np.load(p) as a, np.load(p2) as b:
        assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
        for name in ("s_hi", "s_lo", "s_pos"):
            np.testing.assert_array_equal(a[name], b[name])
            assert a[name].dtype == b[name].dtype


def test_k32_roundtrip_keeps_sign_bit(tmp_path):
    # k=32 patterns use bit 63: saved as uint32 lanes, restored exactly
    seq = "G" * 40 + "T" + "ACGTTGCA" * 12
    t = api.make_kmer_hash(seq, 32, device="cpu")
    p = tmp_path / "k32.npz"
    tckpt.save_index(t, p)
    j = jckpt.load_index(p)
    t2 = tckpt.load_index(p, device="cpu")
    assert api.kmer_pos(t2, 1)["kmer"] == japi.kmer_pos(j, 1)["kmer"]
    assert api.kmer_pos(t2, 1)["kmer"] == api.kmer_pos(t, 1)["kmer"]


def test_bad_file_rejected(tmp_path):
    p = tmp_path / "junk.npz"
    np.savez(p, meta=json.dumps({"magic": "nope"}))
    with pytest.raises(ValueError):
        tckpt.load_index(p, device="cpu")


def counted_pair(tmp_path, k, source_n=2):
    """The same reads counted by both packages, two sources."""
    rng = np.random.default_rng(k)
    genome = "".join(rng.choice(list("ACGT"), size=300))
    paths = []
    for f in range(2):
        p = tmp_path / f"r{f}.fq"
        with open(p, "w") as out:
            for i in range(60):
                a = int(rng.integers(0, 240))
                out.write(f"@r{i}\n{genome[a:a + 60]}\n+\n{'F' * 60}\n")
        paths.append(str(p))
    j = t = None
    for src, p in enumerate(paths):
        src = min(src, source_n - 1)
        j = japi.count_kmers_fq_sh_rp(p, k=k, source_n=source_n, source=src,
                                      store=j)
        t = api.count_kmers_fq_sh_rp(p, k=k, source_n=source_n, source=src,
                                     store=t, device="cpu")
    return t, j, genome


def assert_same_counts(t, j, genome, k):
    assert t.counts_dict() == j.counts_dict()
    np.testing.assert_array_equal(t.total_added, np.asarray(j.total_added))
    np.testing.assert_array_equal(api.kmer_spectrum(t, 30),
                                  japi.kmer_spectrum(j, 30))
    np.testing.assert_array_equal(
        api.seq_kmer_depth(t, genome[:120], k).numpy(),
        japi.seq_kmer_depth(j, genome[:120], k))
    for f in ("k", "counts_n", "prefix_bits", "suffix_bits", "mode"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("k", [13, 32])
def test_count_store_npz_both_directions(tmp_path, k):
    t, j, genome = counted_pair(tmp_path, k)
    assert t.n_unique > 64
    p_port, p_jax = tmp_path / "port.npz", tmp_path / "jax.npz"
    tckpt.save_count_store(t, p_port, progress={"reads_done": 120})
    jckpt.save_count_store(j, p_jax)
    with np.load(p_port) as a, np.load(p_jax) as b:
        ma, mb = json.loads(str(a["meta"])), json.loads(str(b["meta"]))
        assert ma.pop("progress") == {"reads_done": 120}
        assert mb.pop("progress") is None and ma == mb
        for name in ("u_hi", "u_lo", "cnt", "total_added"):
            np.testing.assert_array_equal(a[name], b[name])
            assert a[name].dtype == b[name].dtype, name
    assert_same_counts(tckpt.load_count_store(p_jax, device="cpu"), j,
                       genome, k)
    assert_same_counts(t, jckpt.load_count_store(p_port), genome, k)
    assert jckpt.load_progress(p_port) == {"reads_done": 120}
    assert tckpt.load_progress(p_jax) is None


def test_count_store_from_live_jax_arrays(tmp_path):
    t, j, genome = counted_pair(tmp_path, 13)
    n = j.n_unique
    meta = {"k": j.k, "counts_n": j.counts_n, "prefix_bits": j.prefix_bits,
            "suffix_bits": j.suffix_bits, "mode": j.mode}
    t2 = tckpt.count_store_from_numpy(
        meta, np.asarray(j.u_hi)[:n], np.asarray(j.u_lo)[:n],
        np.asarray(j.cnt)[:n], j.total_added, device="cpu")
    assert_same_counts(t2, j, genome, 13)
    with pytest.raises(ValueError):
        tckpt.count_store_from_numpy(meta, np.zeros(3, np.uint32),
                                     np.zeros(2, np.uint32),
                                     np.zeros((3, 2), np.uint32), [0, 0],
                                     device="cpu")


def test_sharded_checkpoint_loads_whole(tmp_path):
    """A sharded store's file, written by the JAX package, folds into the
    port's single store with every row: more than 64 distinct k-mers per
    shard, compared with the shard tables themselves and with a
    single-device count of the same reads — not with the JAX package's own
    single-store restore, which keeps at most 64 rows of each shard."""
    from kmer_hasher_tpu.parallel import make_mesh

    k = 11
    t, _j, genome = counted_pair(tmp_path, k, source_n=1)
    single = japi.count_kmers_fq_sh_rp(str(tmp_path / "r0.fq"), k=k)
    sharded = japi.count_kmers_fq_sh_rp(str(tmp_path / "r0.fq"), k=k,
                                        mesh=make_mesh(2))
    assert int(min(sharded.n_unique)) > 64
    p = tmp_path / "sharded.npz"
    jckpt.save_count_store(sharded, p)
    with np.load(p) as z:
        assert json.loads(str(z["meta"]))["kind"] == "sharded_count_store"
        keys = ((z["u_hi"].astype(np.uint64) << np.uint64(32))
                | z["u_lo"].astype(np.uint64))
        tables = {int(kk): row.tolist() for kk, row in zip(keys, z["cnt"])}
    got = tckpt.load_count_store(p, device="cpu")
    assert got.counts_dict() == tables == single.counts_dict()
    np.testing.assert_array_equal(got.total_added,
                                  np.asarray(single.total_added))
    np.testing.assert_array_equal(api.kmer_spectrum(got, 30),
                                  japi.kmer_spectrum(single, 30))


def test_bad_count_store_file_rejected(tmp_path):
    p = tmp_path / "junk.npz"
    np.savez(p, meta=json.dumps({"magic": "kmer_hasher_tpu",
                                 "kind": "kmer_index"}))
    with pytest.raises(ValueError):
        tckpt.load_count_store(p, device="cpu")
