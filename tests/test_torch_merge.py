"""Kernel B3's plain version (``ops/cuda_merge.py``) against the JAX
package's merge rounds: its XLA bitonic round and ``lax.sort``, and on
ragged runs against Python's own merge. Everything is integer data, so
equality is exact. The port holds a key as a sortable int64
(``raw ^ 2^63``) and the 32-bit payload in an int32 tensor compared as
unsigned; the JAX package holds uint64 and uint32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu.ops import merge_sort as jms
from kmer_hasher_tpu_torch.ops import cuda_merge

SIGN = np.uint64(1 << 63)
FIVE_KEYS = [0, 1, 2 ** 63, 2 ** 64 - 1, 42]  # repeat-dominated: adversarial


def rand_pairs(n, seed, dup_heavy=False):
    """(uint64 keys, uint32 payloads): random, or five distinct keys over
    all n elements; payloads a permutation with bit 31 set on every third
    (the k = 32 index payload's flag)."""
    rng = np.random.default_rng(seed)
    if dup_heavy:
        keys = rng.choice(np.array(FIVE_KEYS, np.uint64), size=n)
    else:
        keys = rng.integers(0, 2 ** 64 - 1, size=n, dtype=np.uint64)
    pay = rng.permutation(n).astype(np.uint32)
    pay[::3] |= np.uint32(1 << 31)
    return keys, pay


def to_port(keys_u64, pay_u32):
    return (torch.from_numpy((keys_u64 ^ SIGN).view(np.int64)),
            torch.from_numpy(pay_u32.view(np.int32).copy()))


def from_port(k, p):
    return (k.numpy().view(np.uint64) ^ SIGN, p.numpy().view(np.uint32))


def sorted_rows(keys, pay, L):
    """[R, L] rows, each sorted by (key, payload), as phase 1 leaves them."""
    k, p = jax.lax.sort((jnp.asarray(keys.reshape(-1, L)),
                         jnp.asarray(pay.reshape(-1, L))),
                        dimension=-1, num_keys=2)
    return np.asarray(k), np.asarray(p)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("R,L", [(2, 512), (8, 256), (16, 64)])
def test_plain_round_matches_bitonic_round_and_lax_sort(R, L, dup):
    keys, pay = rand_pairs(R * L, R + L, dup)
    k, p = sorted_rows(keys, pay, L)
    got = from_port(*cuda_merge.merge(*to_port(k.reshape(-1), p.reshape(-1)),
                                      np.arange(0, R * L + 1, L)))
    wk, wp = jms._merge_round_bitonic(jnp.asarray(k), jnp.asarray(p))
    np.testing.assert_array_equal(got[0], np.asarray(wk).reshape(-1))
    np.testing.assert_array_equal(got[1], np.asarray(wp).reshape(-1))
    lk, lp = jax.lax.sort((jnp.asarray(k.reshape(R // 2, 2 * L)),
                           jnp.asarray(p.reshape(R // 2, 2 * L))),
                          dimension=-1, num_keys=2)
    np.testing.assert_array_equal(got[0], np.asarray(lk).reshape(-1))
    np.testing.assert_array_equal(got[1], np.asarray(lp).reshape(-1))


RUN_LENGTHS = {
    "unequal": (700, 13, 5, 2049, 1, 1),
    "empty runs": (0, 9, 4, 0, 0, 0, 3, 3),
    "shorter than a tile": (3, 2),
    "one long, one of 1": (4097, 1),
}


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("case", sorted(RUN_LENGTHS))
def test_plain_merge_of_ragged_runs_is_the_python_merge(case, implicit):
    """Any run lengths; all-ones keys (a real value in the port) in both A
    and B with the flag bit of the payload deciding; A first on a tie."""
    rng = np.random.default_rng(len(case))
    lens = RUN_LENGTHS[case]
    vals = np.array(FIVE_KEYS + [7, 2 ** 62], np.uint64)
    runs = []
    for n in lens:
        k = rng.choice(vals, size=n)
        p = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64)
        order = np.lexsort((p, k))
        runs.append((k[order], p[order].astype(np.uint32)))
    keys = np.concatenate([r[0] for r in runs])
    pay = np.concatenate([r[1] for r in runs])
    bounds = np.concatenate([[0], np.cumsum(lens)])
    if implicit:
        pay = np.arange(len(keys), dtype=np.uint32)
    tk, tp = to_port(keys, pay)
    got = from_port(*cuda_merge.merge(tk, None if implicit else tp, bounds))
    want = []
    for i in range(0, len(lens), 2):
        lo, hi = bounds[i], bounds[i + 2]
        want += sorted(zip(keys[lo:hi].tolist(), pay[lo:hi].tolist()))
    assert list(zip(got[0].tolist(), got[1].tolist())) == want


def test_merge_rejects_what_it_does_not_take():
    k = torch.zeros(8, dtype=torch.int64)
    p = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_merge.merge(k.int(), p, (0, 4, 8))
    with pytest.raises(TypeError):
        cuda_merge.merge(k, p.long(), (0, 4, 8))
    with pytest.raises(TypeError):
        cuda_merge.merge(k, p[:4], (0, 4, 8))
    for bad in ((0, 8), (0, 4, 6, 8), (0, 5, 4), (1, 4, 8), (0, 4, 7)):
        with pytest.raises(ValueError):
            cuda_merge.merge(k, p, bad)

