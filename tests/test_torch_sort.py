"""``ops.sort.sort_windows``, the index path's one sort (``torch.sort``),
against the JAX package's ``sort_windows`` and index build, bitwise over the
whole window axis, invalid tail included; the sort of routed rows with
their own positions; and the probes' plain two-key row sort
(``probes._common.lex_sort``) against ``np.lexsort``. The JAX package
takes its ordinary ``lax.sort`` path, as the port's one path does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.ops import sort as jsrt
from kmer_hasher_tpu_torch.ops import encode as enc
from kmer_hasher_tpu_torch.ops import sort as srt
from kmer_hasher_tpu_torch.probes._common import lex_sort

SIGN = np.uint64(1 << 63)
KS = (5, 16, 17, 21, 31, 32)  # packed form, its edge, k-mer alone, k=32


def windows(rng, n, k):
    """Raw k-mer patterns (uint64) and validity: repeats (one k-mer takes a
    quarter of the windows), a tenth of the windows invalid, and for k = 32
    real all-G 32-mers (all ones, the invalid windows' sentinel), valid and
    invalid."""
    top = (1 << (2 * k)) - 1
    raw = rng.integers(0, top, size=n, dtype=np.uint64, endpoint=True)
    raw[rng.integers(0, n, size=n // 4)] = raw[0]
    valid = rng.random(n) < 0.9
    if k == 32:
        at = rng.integers(0, n, size=6)
        raw[at] = np.uint64(top)
        valid[at[:4]] = True
        valid[at[4:]] = False
    return raw, valid


@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
@pytest.mark.parametrize("k", KS)
def test_sort_windows_matches_jax(k, n):
    rng = np.random.default_rng(100 * k + n % 97)
    raw, valid = windows(rng, n, k)
    hi = (raw >> np.uint64(32)).astype(np.uint32)
    lo = raw.astype(np.uint32)
    pos = np.arange(1, n + 1, dtype=np.int32)
    j_hi, j_lo, j_pos = jsrt.sort_windows.__wrapped__(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pos),
        jnp.asarray(valid), k)
    s_key, s_pos = srt.sort_windows(torch.from_numpy(raw.view(np.int64)),
                                    torch.from_numpy(valid), k)
    assert s_pos.dtype == torch.int32
    got = s_key.numpy().view(np.uint64) ^ SIGN
    want = (np.asarray(j_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        j_lo).astype(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(s_pos.numpy(), np.asarray(j_pos))


@pytest.mark.parametrize("k", KS)
def test_batched_sort_windows_equals_its_rows(k):
    """A [B, L] batch (``build_many``'s form) sorts each row as the 1-D
    call sorts it alone, tail included."""
    rng = np.random.default_rng(4 + k)
    raw, valid = windows(rng, 4 * 256, k)
    key = torch.from_numpy(raw.view(np.int64)).reshape(4, 256)
    v = torch.from_numpy(valid).reshape(4, 256)
    got = srt.sort_windows(key, v, k)
    for r in range(4):
        want = srt.sort_windows(key[r], v[r], k)
        assert torch.equal(got[0][r], want[0]) and torch.equal(got[1][r],
                                                               want[1])


@pytest.mark.parametrize("k", [16, 32])
def test_index_build_matches_jax(k):
    """The whole build: the port's index equals the JAX package's over
    the tables, and the JAX arrays handed over through
    ``checkpoint.index_from_numpy`` are the port's own, tail included. The
    sequence's length (3,470 bases) is this file's alone: the JAX package
    caches its build by shape."""
    from kmer_hasher_tpu import api as japi
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.utils import checkpoint

    rng = np.random.default_rng(k)
    seq = "".join(rng.choice(list("ACGTN"), size=3000,
                             p=[.24, .24, .24, .24, .04]))
    seq = seq[:1000] + "G" * 70 + seq[1000:1500] + seq[:400] + seq[1500:]
    t = api.make_kmer_hash(seq, k, device="cpu")
    j = japi.make_kmer_hash(seq, k)
    assert t.n_valid == j.n_valid
    tt, jt = api.kmer_pos(t, 15), japi.kmer_pos(j, 15)
    assert tt["kmer"] == list(jt["kmer"])
    for f in ("pos", "pair.pos", "count"):
        np.testing.assert_array_equal(tt[f].numpy(), np.asarray(jt[f]))
    h = checkpoint.index_from_numpy(k, len(seq), j.s_hi, j.s_lo, j.s_pos,
                                    j.n_valid, device="cpu")
    for name in ("s_key", "s_pos", "starts", "seg_ids", "cum_m"):
        assert torch.equal(getattr(h, name), getattr(t, name)), name


@pytest.mark.parametrize("L", [512, 1000])
@pytest.mark.parametrize("k", KS)
def test_sort_windows_explicit_positions(k, L):
    """Routed rows — the valid windows of a window axis, each with its own
    1-based position, in position order — sort to the implicit form's live
    prefix, which is (key, position) order; all-G 32-mers included. L =
    1000 is a shard of no power-of-two length."""
    rng = np.random.default_rng(k)
    key = torch.from_numpy(rng.integers(0, 24, L)).to(torch.int64)
    if k == 32:
        key[rng.integers(0, L, 40)] = -1  # the raw all-G 32-mer
    else:
        key &= (1 << (2 * k)) - 1
    valid = torch.from_numpy(rng.random(L) < 0.6)
    s_key, s_pos = srt.sort_windows(key, valid, k)
    n = int(valid.sum())
    pos = torch.arange(1, L + 1, dtype=torch.int32)[valid]
    e_key, e_pos = srt.sort_windows(key[valid], torch.ones(n, dtype=torch.bool),
                                    k, pos=pos)
    assert torch.equal(e_key, s_key[:n]) and torch.equal(e_pos, s_pos[:n])
    assert e_pos.dtype == torch.int32
    order = np.lexsort((pos.numpy(), enc.sortable_key(key[valid]).numpy()))
    np.testing.assert_array_equal(e_pos.numpy(), pos.numpy()[order])
    # explicit positions equal to the index: the implicit form, tail too
    full = srt.sort_windows(key, valid, k, pos=torch.arange(
        1, L + 1, dtype=torch.int32))
    assert torch.equal(full[0], s_key) and torch.equal(full[1], s_pos)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("shape", [(1 << 13,), (8, 512)])
def test_lex_sort_matches_np_lexsort(shape, dup):
    """(key, payload) order with the payload unsigned: bit 31 is set on
    every third payload (the k = 32 index payload's flag); five distinct
    keys over every element where ``dup``, the all-ones key among them."""
    rng = np.random.default_rng(len(shape) + 2 * dup)
    n = int(np.prod(shape))
    if dup:
        keys = rng.choice(np.array([0, 1, 2 ** 63, 2 ** 64 - 1, 42],
                                   np.uint64), size=n)
    else:
        keys = rng.integers(0, 2 ** 64 - 1, size=n, dtype=np.uint64)
    pay = rng.integers(0, 1 << 20, size=n).astype(np.uint32)
    pay[::3] |= np.uint32(1 << 31)
    keys, pay = keys.reshape(shape), pay.reshape(shape)
    s_key, s_pay = lex_sort(torch.from_numpy((keys ^ SIGN).view(np.int64)),
                            torch.from_numpy(pay.view(np.int32).copy()))
    order = np.lexsort((pay, keys), axis=-1)
    np.testing.assert_array_equal(s_key.numpy().view(np.uint64) ^ SIGN,
                                  np.take_along_axis(keys, order, -1))
    np.testing.assert_array_equal(s_pay.numpy().view(np.uint32),
                                  np.take_along_axis(pay, order, -1))
