"""The port's quality-likelihood FSM (``ops/scan_iter.ll_scan``, the plain
version of kernel B2, which is what runs on the CPU) against the JAX
package: ``ll_scan`` in its three precisions and the Pallas kernel B2 in
interpret mode. Every output is a boolean or an integer pattern, so the
tolerance is exact, bitwise equality — emit, both registers at EVERY
position, and the per-read flag. The Pallas kernel's registers are defined
at emitting positions only, and are compared there.

The f32 paths depend on the f32 log-likelihood values. The port evaluates
them once with numpy float32; the JAX package evaluates the same formula
with XLA. To compare bit for bit the port's ``ll_scan`` is handed the JAX
package's own values and bound; with the port's own table the tests hold
the flag to what it is for: every fast-vs-exact decision flip lies on a
flagged read, and hybrid equals exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.ops import scan_iter as jsi
from kmer_hasher_tpu.ops.pallas_scan import ll_scan_pallas
from kmer_hasher_tpu.qll import Q_TO_LL
from kmer_hasher_tpu_torch.ops import cuda_scan
from kmer_hasher_tpu_torch.ops import scan_iter as tsi

CASES = [(5, 20), (16, 10), (21, 20), (32, 0)]


def raw(hi, lo):
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).view(np.int64)


def jax_table():
    return np.asarray(jsi.analytic_ll_f32(jnp.arange(256, dtype=jnp.uint8)))


def ragged_batch(seed, k, B=24, L=70, qual="any"):
    """Mixed-case reads with N; lengths 0, k, k+1, full and random."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=(B, L))
    if qual == "any":
        q = (33 + rng.integers(0, 42, size=(B, L))).astype(np.uint8)
    elif qual == "binned":
        q = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=(B, L),
                       p=[0.88, 0.08, 0.02, 0.02])
    else:  # stress: phred 30-40 with ~2% low-quality bases
        q = rng.integers(63, 74, size=(B, L)).astype(np.uint8)
        low = rng.random((B, L)) < 0.02
        q[low] = rng.integers(35, 53, size=int(low.sum())).astype(np.uint8)
    lengths = rng.integers(max(0, k - 2), L + 1, size=B).astype(np.int32)
    lengths[:4] = (0, k, k + 1, L)
    return seq, q, lengths


def tensors(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def assert_same(got, want, where=None):
    """Port (emit, fwd, rc[, flag]) == JAX (emit, fhi, flo, rhi, rlo[, flag]);
    registers compared at ``where`` (default everywhere)."""
    emit = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), emit)
    sel = np.ones_like(emit) if where is None else where
    np.testing.assert_array_equal(got[1].numpy()[sel],
                                  raw(want[1], want[2])[sel])
    np.testing.assert_array_equal(got[2].numpy()[sel],
                                  raw(want[3], want[4])[sel])
    if len(got) > 3:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[5]))


@pytest.mark.parametrize("k,min_q", CASES)
def test_exact_matches_jax(k, min_q):
    seq, qual, lengths = ragged_batch(k, k)
    min_ll = float(Q_TO_LL[33 + min_q])
    want = jsi.ll_scan(seq, qual, lengths, k, jnp.asarray(min_ll),
                       precision="exact")
    got = tsi.ll_scan(*tensors(seq, qual, lengths), k, min_ll,
                      precision="exact")
    assert_same(got, want)


@pytest.mark.parametrize("with_char", [False, True])
@pytest.mark.parametrize("k,min_q", CASES)
def test_fast_and_flags_match_jax_and_pallas(k, min_q, with_char):
    seq, qual, lengths = ragged_batch(100 + k, k)
    min_ll = float(Q_TO_LL[33 + min_q])
    mc = 33 + min_q if with_char else None
    args = tensors(seq, qual, lengths)
    hand = dict(ll_table=jax_table(), rel_bound=jsi._rel_bound())
    want = jsi.ll_scan(seq, qual, lengths, k, jnp.asarray(min_ll),
                       precision="fast", return_flags=True, min_q_char=mc)
    got = tsi.ll_scan(*args, k, min_ll, precision="fast", return_flags=True,
                      min_q_char=mc, **hand)
    assert_same(got, want)
    # the flag-free instantiation takes the same decisions
    plain = tsi.ll_scan(*args, k, min_ll, precision="fast", min_q_char=mc,
                        ll_table=hand["ll_table"])
    assert len(plain) == 3
    for a, b in zip(plain, got):
        assert torch.equal(a, b)
    # B2 as the JAX package's own tests run it on the CPU
    pal = ll_scan_pallas(seq, qual, lengths, k, min_ll, interpret=True,
                         pb=2, return_flags=True, min_q_char=mc)
    assert_same(got, pal, where=np.asarray(pal[0]))


def test_flag_threshold_sweep_matches_jax():
    """Thresholds swept around an achievable window sum, so comparisons
    land inside the tracked-error band and some reads flag (as
    tests/test_pallas_scan.py does): flags and emits stay bitwise equal."""
    k = 9
    rng = np.random.default_rng(1)
    B, L = 16, 40
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(B, L))]
    qual = (33 + rng.integers(2, 11, size=(B, L))).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    table = jax_table()
    sums = np.lib.stride_tricks.sliding_window_view(
        table[qual].astype(np.float64), k + 1, axis=1).sum(-1)
    anchor = np.sort(sums.ravel())[sums.size // 6]
    any_flag = False
    for off in (-2.5e-6, 0.0, 2e-6, 3e-6):
        min_ll = float(anchor + off)
        want = jsi.ll_scan(seq, qual, lengths, k, jnp.asarray(min_ll),
                           precision="fast", return_flags=True)
        got = tsi.ll_scan(*tensors(seq, qual, lengths), k, min_ll,
                          precision="fast", return_flags=True,
                          ll_table=table, rel_bound=jsi._rel_bound())
        assert_same(got, want)
        any_flag |= bool(got[3].any())
    assert any_flag


@pytest.mark.parametrize("quals", ["any", "binned", "stress"])
@pytest.mark.parametrize("k,min_q", [(9, 2), (21, 20)])
def test_own_table_flags_are_sound_and_hybrid_equals_exact(k, min_q, quals):
    """With the port's own f32 table: every read whose fast decisions
    differ from exact is flagged, so re-scanning flagged reads exactly
    reproduces the exact emits; binned and stress tracks flag few reads."""
    seq, qual, lengths = ragged_batch(7 * k + min_q, k, B=96, L=100,
                                      qual=quals)
    args = tensors(seq, qual, lengths)
    min_ll = float(Q_TO_LL[33 + min_q])
    exact = tsi.ll_scan(*args, k, min_ll, precision="exact")
    fast = tsi.ll_scan(*args, k, min_ll, precision="fast",
                       return_flags=True, min_q_char=33 + min_q)
    flags = fast[3]
    flips = (fast[0] != exact[0]).any(dim=1)
    assert not bool((flips & ~flags).any()), "unflagged read diverged"
    hybrid = torch.where(flags[:, None], exact[0], fast[0])
    assert torch.equal(hybrid, exact[0])
    ok = ~flags
    assert torch.equal(fast[1][ok], exact[1][ok])
    assert torch.equal(fast[2][ok], exact[2][ok])
    if quals != "any":
        assert float(flags.float().mean()) < 0.05


def test_own_table_threshold_sweep_flags_cover_all_flips():
    k = 9
    rng = np.random.default_rng(7)
    B, L, Q = 32, 64, 40
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(B, L))]
    qual = np.full((B, L), 33 + Q, np.uint8)
    args = tensors(seq, qual, np.full(B, L, np.int32))
    base = (k + 1) * float(Q_TO_LL[33 + Q])
    any_flag = False
    for off in np.linspace(-2e-6, 2e-6, 21):
        min_ll = base + float(off)
        fast = tsi.ll_scan(*args, k, min_ll, precision="fast",
                           return_flags=True)
        exact = tsi.ll_scan(*args, k, min_ll, precision="exact")
        flips = (fast[0] != exact[0]).any(dim=1)
        assert not bool((flips & ~fast[3]).any())
        any_flag |= bool(fast[3].any())
    assert any_flag


def test_own_table_and_bound():
    t = tsi.ll_table_f32()
    assert t.dtype == np.float32 and t.shape == (256,)
    assert (t[:34] == np.float32(-708.0)).all()
    np.testing.assert_allclose(t[34:], Q_TO_LL[34:], rtol=2e-6, atol=2e-12)
    assert tsi.fast_min_ll(53) == float(t[53])
    assert 0 < tsi._rel_bound() < 1e-5
    assert tsi._rel_bound() == tsi._rel_bound_of(t)
    assert tsi._ABS0 == jsi._ABS0
    # a table that merges two qualities voids the q == min_q exemptions
    bad = t.copy()
    bad[60] = bad[59]
    with pytest.raises(AssertionError):
        tsi._rel_bound_of(bad)
    bad = t.copy()
    bad[60] = bad[58]
    with pytest.raises(AssertionError):
        tsi._rel_bound_of(bad)


def test_wrapper_runs_plain_version_on_cpu_and_validates():
    seq, qual, lengths = ragged_batch(3, 11)
    args = tensors(seq, qual, lengths)
    before = cuda_scan.scan.launches
    got = cuda_scan.scan(*args, 11, -0.01, precision="fast",
                         return_flags=True)
    want = tsi.ll_scan(*args, 11, -0.01, precision="fast", return_flags=True)
    assert cuda_scan.scan.launches == before  # no kernel for CPU tensors
    assert cuda_scan.plain is tsi.ll_scan
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tsi.ll_scan(*args, 33, -0.01)
    with pytest.raises(ValueError):
        tsi.ll_scan(*args, 11, -0.01, precision="exact", return_flags=True)
    with pytest.raises(ValueError):
        tsi.ll_scan(*args, 11, -0.01, precision="double")
    with pytest.raises(ValueError):
        tsi.ll_scan(args[0], args[1][:, :5], args[2], 11, -0.01)
