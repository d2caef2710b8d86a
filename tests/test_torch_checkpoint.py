"""Index checkpoints across packages: an npz saved by either package loads
in the other and answers the same queries, exactly."""
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
    t = api.make_kmer_hash(seq, k)
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
    t = tckpt.load_index(p)
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
    t = api.make_kmer_hash(seq, 32)
    p = tmp_path / "k32.npz"
    tckpt.save_index(t, p)
    j = jckpt.load_index(p)
    t2 = tckpt.load_index(p)
    assert api.kmer_pos(t2, 1)["kmer"] == japi.kmer_pos(j, 1)["kmer"]
    assert api.kmer_pos(t2, 1)["kmer"] == api.kmer_pos(t, 1)["kmer"]


def test_bad_file_rejected(tmp_path):
    p = tmp_path / "junk.npz"
    np.savez(p, meta=json.dumps({"magic": "nope"}))
    with pytest.raises(ValueError):
        tckpt.load_index(p)
