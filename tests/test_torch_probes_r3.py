"""The plain versions of the round-3 probe kernels P5–P8 against the JAX
package's Pallas probes themselves, bitwise (they move 32-bit elements: no
tolerance), and the plain probes R1 and R5 against the JAX functions.

``tools/chip_probes/sort_probes_r3.py`` runs here unedited, in interpret
mode, through the recording loader of ``test_torch_probes.py``; its timer is
replaced by one that records each timed function's arguments and output. All
four Pallas kernels run in interpret mode, semaphore arrays included. P5's
Pallas output leaves the rows no step wrote undefined, so it is compared on
the written rows; its overlapping write windows are held against a numpy
loop. Edge inputs are held against numpy, and the port's entry point runs
on the CPU."""
import jax
import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (enables jax_enable_x64, as the script needs)
from kmer_hasher_tpu_torch.probes import _common, cuda_probes as cp
from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3
from kmer_hasher_tpu_torch.probes import sort_probes, sort_probes_r3
from test_torch_probes import i32, load_recording, same_bits

WRAPPERS = (cp3.dyn_copy_2d, cp3.small_copy, cp3.async_copy, cp3.smem_gather)


@pytest.fixture
def jax_r3(monkeypatch):
    """(the JAX round-3 probe module, its recorded pallas calls, its timed
    calls as (args, outputs) in numpy)."""
    mod, calls = load_recording(monkeypatch, "sort_probes_r3.py")
    timed = []

    def timeit(fn, *args, iters=3):
        out = fn(*args)
        timed.append(([np.asarray(a) for a in args],
                      [np.asarray(o) for o in jax.tree_util.tree_leaves(out)]))
        return 1e-3

    monkeypatch.setattr(mod, "timeit", timeit)
    return mod, calls, timed


def numpy_p5(x: np.ndarray, offs: np.ndarray, r: int):
    """numpy's statement of P5: (output, which rows some step wrote)."""
    out = np.zeros_like(x)
    written = np.zeros(x.shape[0], bool)
    for t in range(len(offs)):
        a, d = int(offs[t]), int(offs[len(offs) - 1 - t])
        if 0 <= a <= x.shape[0] - r and 0 <= d <= x.shape[0] - r:
            out[d: d + r] = x[a: a + r]
            written[d: d + r] = True
    return out, written


@pytest.mark.parametrize("r", [512, 8])
def test_p5_plain_equals_the_pallas_2d_copy(jax_r3, r, capsys):
    mod, calls, _ = jax_r3
    with jax.disable_jit():
        mod.r2_dyn_dma_2d(1 << 18, r)
    (offs, x), out = calls[0]
    assert offs.shape == (64,) and x.shape == (2048, 128) == out.shape
    want, written = numpy_p5(x, offs, r)
    # with 64 windows of 512 rows in 2,048 the write windows overlap: the
    # Pallas grid ran its steps in order, and so does the plain version
    if r == 512:
        assert written.sum() < 64 * r
    got = cp3.plain_dyn_copy_2d(i32(x), torch.from_numpy(offs), r)
    assert same_bits(got, want)
    assert np.array_equal(got.numpy().view(np.uint32)[written], out[written])
    assert same_bits(cp3.dyn_copy_2d(i32(x), torch.from_numpy(offs), r), want)
    assert np.array_equal(
        sort_probes_r3.reference_row_offsets(2048, r, 64), offs)
    src = sort_probes_r3.sequential_source_rows(2048, offs, r)
    assert np.array_equal(src >= 0, written)
    assert np.array_equal(x[src[written]], want[written])
    assert "R2 2-D dyn-DMA" in capsys.readouterr().out


def test_p5_overlapping_windows_and_edges_against_numpy():
    """Write windows made to overlap (neighbours one row apart, repeats, a
    window inside another's span), R that is no multiple of the kernel's
    row chunk, and steps whose window lies outside x: skipped whole."""
    rng = np.random.default_rng(5)
    rows = 700
    x = rng.integers(0, 2 ** 32, size=(rows, 128), dtype=np.uint32)
    for r, offs in (
            (130, [0, 1, 2, 3, 129, 130, 131, 400, 400, 569, 570, 5]),
            (3, [10, 11, 12, 13, 14, 10, 697, 0, 1]),
            (1, [5, 5, 6, 5]),
            (200, [0, 100, 501, -1, 500, 2 ** 31 - 1, 300, -2 ** 31]),
            (700, [0, 0, 1])):
        offs = np.array(offs, np.int32)
        want, _ = numpy_p5(x, offs, r)
        assert same_bits(cp3.dyn_copy_2d(i32(x), torch.from_numpy(offs), r),
                         want), (r, offs)
    assert not cp3.dyn_copy_2d(i32(x), torch.zeros(0, dtype=torch.int32),
                               8).any()
    with pytest.raises(ValueError):
        cp3.dyn_copy_2d(i32(x), torch.zeros(2, dtype=torch.int32), 701)
    with pytest.raises(ValueError):
        cp3.dyn_copy_2d(i32(x), torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        cp3.dyn_copy_2d(i32(x).reshape(-1), torch.zeros(2, dtype=torch.int32),
                        8)
    with pytest.raises(TypeError):
        cp3.dyn_copy_2d(i32(x), torch.zeros(2, dtype=torch.int64), 8)


def test_p6_plain_equals_the_pallas_small_copies(jax_r3, capsys):
    mod, calls, _ = jax_r3
    with jax.disable_jit():
        mod.r2b_small_dma_rate(1 << 16)
    (offs, x), out = calls[0]
    assert offs.shape == (4096,) and out.shape == (4096 * 4, 128)
    assert same_bits(cp3.plain_small_copy(i32(x), torch.from_numpy(offs)), out)
    assert same_bits(cp3.small_copy(i32(x), torch.from_numpy(offs)), out)
    assert np.array_equal(
        sort_probes_r3.reference_row_offsets(x.shape[0], 4, 4096), offs)
    assert "ok=True" in capsys.readouterr().out


def test_p6_edge_offsets_against_numpy():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 2 ** 32, size=(50, 128), dtype=np.uint32)
    offs = np.array([0, 46, 1, 1, 45, 47, -1, 50, 2 ** 31 - 1], np.int32)
    want = np.concatenate([
        x[o: o + 4] if 0 <= o <= 46 else np.zeros((4, 128), np.uint32)
        for o in offs.tolist()])
    assert same_bits(cp3.small_copy(i32(x), torch.from_numpy(offs)), want)
    assert cp3.small_copy(i32(x), torch.zeros(0, dtype=torch.int32)
                          ).shape == (0, 128)
    with pytest.raises(ValueError):
        cp3.small_copy(i32(x[:3]), torch.from_numpy(offs))
    with pytest.raises(ValueError):
        cp3.small_copy(i32(x)[:, :64], torch.from_numpy(offs))


@pytest.mark.parametrize("granule", [1024, 1])
def test_p7_plain_equals_the_pallas_1d_copy(jax_r3, granule, capsys):
    mod, calls, _ = jax_r3
    with jax.disable_jit():
        mod.r3_dyn_dma_1d(1 << 18, granule)
    (offs, x), out = calls[0]
    assert offs.shape == (64,) and out.shape == (64 * cp.CH,)
    assert same_bits(cp3.plain_async_copy(i32(x), torch.from_numpy(offs)), out)
    assert same_bits(cp3.async_copy(i32(x), torch.from_numpy(offs)), out)
    # P2's function, and P2's reference offsets
    assert same_bits(cp.dyn_copy(i32(x), torch.from_numpy(offs)), out)
    assert np.array_equal(sort_probes.reference_offsets(1 << 18, granule),
                          offs)
    assert "ok=True" in capsys.readouterr().out


def test_p7_edge_offsets_and_refusals():
    rng = np.random.default_rng(7)
    n = 2 * cp.CH + 5
    x = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    offs = np.array([0, n - cp.CH, 1, 2, 3, 4, 4], np.int32)
    want = np.concatenate([x[o: o + cp.CH] for o in offs])
    assert same_bits(cp3.async_copy(i32(x), torch.from_numpy(offs)), want)
    assert cp3.async_copy(i32(x), torch.zeros(0, dtype=torch.int32)
                          ).shape == (0,)
    with pytest.raises(ValueError):
        cp3.async_copy(i32(x[: cp.CH - 1]), torch.from_numpy(offs))
    with pytest.raises(TypeError):
        cp3.async_copy(i32(x), torch.from_numpy(offs).long())


def test_p8_plain_equals_the_pallas_gather(jax_r3, capsys):
    mod, calls, _ = jax_r3
    with jax.disable_jit():
        mod.r4_vmem_gather(1 << 14)
    (tab, idx), out = calls[0]
    assert tab.shape == (8, 128) and idx.shape == (128, 128) == out.shape
    assert same_bits(cp3.plain_smem_gather(i32(tab), torch.from_numpy(idx)),
                     out)
    assert same_bits(cp3.smem_gather(i32(tab), torch.from_numpy(idx)), out)
    assert "ok=True" in capsys.readouterr().out


def test_p8_an_index_outside_the_table_gives_zero():
    rng = np.random.default_rng(8)
    tab = rng.integers(1, 2 ** 32, size=(8, 128), dtype=np.uint32)
    idx = np.array([0, 1023, 1024, -1, 5, 2 ** 31 - 1, -2 ** 31, 512],
                   np.int32)
    want = np.where((idx >= 0) & (idx < 1024),
                    tab.reshape(-1)[np.clip(idx, 0, 1023)], 0).astype(
                        np.uint32)
    assert same_bits(cp3.smem_gather(i32(tab), torch.from_numpy(idx)), want)
    assert same_bits(cp3.smem_gather(i32(tab).reshape(-1),
                                     torch.from_numpy(idx).reshape(2, 4)),
                     want.reshape(2, 4))
    with pytest.raises(ValueError):
        cp3.smem_gather(i32(tab[:4]), torch.from_numpy(idx))
    with pytest.raises(TypeError):
        cp3.smem_gather(i32(tab), torch.from_numpy(idx).long())


def test_r1_sorts_equal_the_jax_sorts(jax_r3, capsys):
    mod, _, timed = jax_r3
    n = 1 << 12
    mod.r1_u32_key_sorts(n)
    assert len(timed) == 3
    k32, p1, p2 = sort_probes_r3.r1_inputs(n)
    for got, want in zip(timed[1][0], (k32, p1, p2)):
        assert np.array_equal(got, want)  # the port draws the same inputs
    # many equal keys as well, so that stability shows
    for key in (k32, k32 % 7):
        jk = jax.numpy.asarray(key)
        args = [i32(a) for a in (key, p1, p2)]
        want = jax.lax.sort((jk, p1, p2), num_keys=1, is_stable=True)
        got = sort_probes_r3.sort_u32_key(*args)
        for g, w in zip(got, want):
            assert same_bits(g, np.asarray(w))
        got = sort_probes_r3.sort_u32_key(*args[:2])
        assert same_bits(got[0], np.asarray(want[0]))
        assert same_bits(got[1], np.asarray(want[1]))
    (a_k, a_p), (w_kk, w_p) = timed[2]  # the 64-bit-key control
    g_kk, g_p = sort_probes_r3.sort_u64_key(i32(a_k), i32(a_p))
    assert w_kk.dtype == np.uint64
    assert np.array_equal(g_kk.numpy().view(np.uint64), w_kk)
    assert same_bits(g_p, w_p)
    for (args, want), arity in zip(timed[:2], (2, 3)):
        got = sort_probes_r3.sort_u32_key(*(i32(a) for a in args))
        assert len(got) == len(want) == arity
        for g, w in zip(got, want):
            assert same_bits(g, w)
    assert "R1 u32key+2pay" in capsys.readouterr().out


@pytest.mark.parametrize("log_l", [13, 15])
def test_r5_clean_equals_the_jax_clean(log_l):
    """The same bitonic rows through the JAX script's stages (written out
    here as there, with jax.numpy) and the port's: equal keys and payloads,
    rows ascending."""
    jnp = jax.numpy
    L, R = 1 << log_l, 3
    n = R * L
    rng = np.random.default_rng(log_l)
    a = np.sort(rng.integers(0, 2 ** 63, (R, L // 2), np.uint64), -1)
    b = np.sort(rng.integers(0, 2 ** 63, (R, L // 2), np.uint64), -1)
    a[:, : L // 8] = b[:, : L // 8]  # ties between the halves
    b.sort(-1)
    a.sort(-1)
    k1 = np.concatenate([a, b[:, ::-1]], -1).reshape(-1)
    k2 = np.arange(n, dtype=np.uint32)

    def clean(k1, k2):
        k1, k2 = k1.reshape(R, L), k2.reshape(R, L)
        stride = L // 2
        while stride >= 1:
            v1 = k1.reshape(R, -1, 2, stride)
            v2 = k2.reshape(R, -1, 2, stride)
            x1, y1 = v1[:, :, 0, :], v1[:, :, 1, :]
            x2, y2 = v2[:, :, 0, :], v2[:, :, 1, :]
            le = x1 <= y1
            k1 = jnp.stack([jnp.where(le, x1, y1),
                            jnp.where(le, y1, x1)], 2).reshape(R, L)
            k2 = jnp.stack([jnp.where(le, x2, y2),
                            jnp.where(le, y2, x2)], 2).reshape(R, L)
            stride //= 2
        return k1, k2

    w1, w2 = clean(jnp.asarray(k1), jnp.asarray(k2))
    g1, g2 = sort_probes_r3.bitonic_clean(
        torch.from_numpy(k1.view(np.int64)), i32(k2), R, L)
    assert np.array_equal(g1.numpy().view(np.uint64), np.asarray(w1))
    assert same_bits(g2, np.asarray(w2))
    assert (np.diff(g1.numpy(), axis=-1) >= 0).all()
    t1, _ = sort_probes_r3.bitonic_rows(n, L, torch.device("cpu"))
    rows = t1.reshape(R, L).numpy()
    assert (np.diff(rows[:, : L // 2]) >= 0).all()
    assert (np.diff(rows[:, L // 2:]) <= 0).all()


def test_r5_jax_script_runs_its_clean(jax_r3, capsys):
    """The JAX script's own R5 at a small n (its rows come out ascending),
    and the port's stages on the very rows it timed."""
    mod, _, timed = jax_r3
    n = 1 << 16
    mod.r5_bitonic_clean_rows(n)
    assert capsys.readouterr().out.count("ok=True") == 2
    for (k1, k2), (w1, w2) in timed:
        L = w1.shape[1]
        g1, g2 = sort_probes_r3.bitonic_clean(
            torch.from_numpy(k1.view(np.int64)), i32(k2), n // L, L)
        assert np.array_equal(g1.numpy().view(np.uint64), w1)
        assert same_bits(g2, w2)


def test_spread_row_offsets_cover_x_once():
    for r in (512, 8, 4):
        offs = sort_probes_r3.spread_row_offsets(1 << 12, r)
        assert offs.dtype == np.int32
        assert sorted(offs.tolist()) == list(range(0, 1 << 12, r))
        src = sort_probes_r3.sequential_source_rows(1 << 12, offs, r)
        assert sorted(src.tolist()) == list(range(1 << 12))


def test_entry_point_on_the_cpu(capsys):
    """``sort_probes_r3 17 --device cpu``: every line says ok=True and names
    the host clock, in the JAX script's order, and no wrapper counts a
    launch (no kernel ran)."""
    before = tuple(w.launches for w in WRAPPERS)
    sort_probes_r3.main(["17", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device ready")
    probes = lines[1:]
    assert [ln.split()[0] for ln in probes] == (
        ["R1"] * 3 + ["R5"] * 2 + ["R2"] * 4 + ["R2b"] * 2 + ["R4"] * 2
        + ["R3"] * 4)
    for ln in probes:
        assert "ok=True" in ln and ln.endswith(_common.card_line(
            torch.device("cpu"))), ln
    assert before == tuple(w.launches for w in WRAPPERS)
    # the reference's 64 windows of 512 rows overlap: fewer rows written
    r2 = [ln for ln in probes if ln.startswith("R2 ") and "=512" in ln][0]
    assert "steps=64" in r2 and f"({64 * 512} of" not in r2
    with pytest.raises(ValueError):
        sort_probes_r3.run(16, device="cpu")


def test_a_failing_probe_raises(monkeypatch, capsys):
    """Unlike the JAX script, which prints a failure and goes on."""
    monkeypatch.setattr(cp3, "plain_small_copy",
                        lambda x, offs: cp3.plain_dyn_copy_2d(
                            x, offs[:1], 4)[: 4 * len(offs)] + 1)
    monkeypatch.setattr(sort_probes_r3, "r1_u32_key_sorts",
                        lambda *a: [])
    monkeypatch.setattr(sort_probes_r3, "r5_bitonic_clean_rows",
                        lambda *a: [])
    with pytest.raises(RuntimeError, match="probe failed: R2b"):
        sort_probes_r3.run(17, device="cpu")
    assert "ok=False" in capsys.readouterr().out
