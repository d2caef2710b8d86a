"""The plain versions of the DMA probe kernels P9 (with D2) and P10 against
the JAX package's Pallas probes themselves, bitwise over the whole output
(they move 32-bit elements: no tolerance), and the plain merge networks of
D4 against the JAX script's functions.

``tools/chip_probes/dma_probes_r3.py`` runs here unedited, in interpret
mode, through the recording loader of ``test_torch_probes.py``, under
``jax.disable_jit()``; its timer is replaced by one that calls the timed
function once. D1's DMA semaphores and scalar prefetch run in interpret
mode (with 64-bit types off, as the kernel's index arithmetic needs), and
its whole output is held against the port's plain version (the
script's own check reads one window, and the wrong one: it holds only when
the permutation's first entry is 0). Edge inputs are held against numpy,
and the port's entry point runs on the CPU."""
import jax
import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (enables jax_enable_x64, as D4 needs)
from kmer_hasher_tpu_torch.probes import _common
from kmer_hasher_tpu_torch.probes import cuda_probes_dma as cpd
from kmer_hasher_tpu_torch.probes import dma_probes_r3
from test_torch_probes import i32, load_recording, same_bits
from test_torch_probes_r3 import numpy_p5

WRAPPERS = (cpd.pipelined_copy, cpd.lane_gather)


@pytest.fixture
def jax_dma(monkeypatch):
    """(the JAX DMA probe module, its recorded pallas calls)."""
    mod, calls = load_recording(monkeypatch, "dma_probes_r3.py")
    monkeypatch.setattr(mod, "timeit", lambda fn, *args, iters=3: (
        fn(*args), 1e-3)[1])
    return mod, calls


@pytest.mark.parametrize("r,dynamic", [(8, True), (32, True), (8, False),
                                       (32, False)])
def test_p9_plain_equals_the_pallas_pipelined_copy(jax_dma, r, dynamic,
                                                   capsys):
    mod, calls = jax_dma
    n = 1 << 14
    # the kernel's lax.rem(program_id, 2) wants 32-bit integers: x64 off
    with jax.disable_jit(), jax.enable_x64(False):
        mod.d1_pipelined_dyn_dma(n, r, dynamic=dynamic)
    (offs, x), out = calls[0]
    rows = n // 128
    assert x.shape == (rows, 128) == out.shape and offs.shape == (rows // r,)
    got = cpd.plain_pipelined_copy(
        i32(x), torch.from_numpy(offs) if dynamic else None, r)
    assert same_bits(got, out)  # the whole output
    want, written = numpy_p5(x, offs if dynamic else
                             np.arange(rows // r, dtype=np.int32) * r, r)
    assert written.all() and same_bits(got, want)
    assert same_bits(cpd.pipelined_copy(
        i32(x), torch.from_numpy(offs) if dynamic else None, r), out)
    printed = capsys.readouterr().out
    if dynamic:
        assert np.array_equal(dma_probes_r3.window_offsets(rows, r), offs)
        # the script's own check compares out[:R] with x[offs[T-1]:+R]
        assert ("ok=True" in printed) == (int(offs[0]) == 0)


def test_p9_overlapping_windows_and_edges_against_numpy():
    """P9 is P5's function: overlapping write windows (the later step's
    rows stand), steps whose window leaves x (skipped whole), one step, and
    D2 on rows that R does not divide (the rows past T*R stay zero)."""
    rng = np.random.default_rng(9)
    rows = 300
    x = rng.integers(0, 2 ** 32, size=(rows, 128), dtype=np.uint32)
    for r, offs in (
            (40, [0, 1, 2, 39, 40, 41, 260, 260, 259, 5]),
            (33, [0, 33, -1, 268, 267, 2 ** 31 - 1, -2 ** 31, 100]),
            (300, [0]),
            (7, [3]),
            (1, [5, 5, 6, 5])):
        offs = np.array(offs, np.int32)
        want, _ = numpy_p5(x, offs, r)
        assert same_bits(cpd.pipelined_copy(i32(x), torch.from_numpy(offs),
                                            r), want), (r, offs)
    for r in (7, 64, 300):
        t = rows // r
        want, _ = numpy_p5(x, np.arange(t, dtype=np.int32) * r, r)
        assert not want[t * r:].any()
        assert same_bits(cpd.pipelined_copy(i32(x), None, r), want), r
    assert not cpd.pipelined_copy(i32(x), torch.zeros(0, dtype=torch.int32),
                                  8).any()
    with pytest.raises(ValueError):
        cpd.pipelined_copy(i32(x), None, 301)
    with pytest.raises(ValueError):
        cpd.pipelined_copy(i32(x)[:, :64], None, 8)
    with pytest.raises(TypeError):
        cpd.pipelined_copy(i32(x), torch.zeros(2, dtype=torch.int64), 8)


def test_p10_plain_equals_the_pallas_lane_gather(jax_dma, capsys):
    mod, calls = jax_dma
    with jax.disable_jit():
        mod.d3_gather_2d()
    (tab, idx), out = calls[0]
    assert tab.shape == (1024, 128) and idx.shape == out.shape == (8192, 128)
    assert same_bits(cpd.plain_lane_gather(i32(tab), torch.from_numpy(idx)),
                     out)
    assert same_bits(cpd.lane_gather(i32(tab), torch.from_numpy(idx)), out)
    p_tab, p_idx = dma_probes_r3.gather_inputs(1 << 20, torch.device("cpu"))
    assert same_bits(p_tab, tab) and np.array_equal(p_idx.numpy(), idx)
    assert "ok=True" in capsys.readouterr().out


def test_p10_an_index_outside_the_table_gives_zero():
    rng = np.random.default_rng(10)
    tab = rng.integers(1, 2 ** 32, size=(1024, 128), dtype=np.uint32)
    idx = rng.integers(-3000, 3000, size=(40, 128)).astype(np.int32)
    idx[0, :6] = [0, 1023, 1024, -1, 2 ** 31 - 1, -2 ** 31]
    ok = (idx >= 0) & (idx < 1024)
    want = np.where(ok, np.take_along_axis(tab, np.clip(idx, 0, 1023), 0),
                    0).astype(np.uint32)
    assert 0 < ok.mean() < 1
    assert same_bits(cpd.lane_gather(i32(tab), torch.from_numpy(idx)), want)
    with pytest.raises(ValueError):
        cpd.lane_gather(i32(tab[:512]), torch.from_numpy(idx))
    with pytest.raises(ValueError):
        cpd.lane_gather(i32(tab), torch.from_numpy(idx[:, :64]))
    with pytest.raises(TypeError):
        cpd.lane_gather(i32(tab), torch.from_numpy(idx).long())


@pytest.mark.parametrize("log_m", [14, 16])
def test_d4_networks_equal_the_jax_networks(jax_dma, log_m):
    """The port's flat and row-fused networks against the script's own
    ``_merge_flat`` and ``_merge_rowfused`` (jax.numpy in x64) on a bitonic
    array with ties between the halves: keys and payloads bitwise."""
    mod, _ = jax_dma
    jnp = jax.numpy
    m = 1 << log_m
    rng = np.random.default_rng(log_m)
    a = np.sort(rng.integers(0, 2 ** 63, m // 2, np.uint64))
    b = np.sort(rng.integers(0, 2 ** 63, m // 2, np.uint64))
    a[: m // 8] = b[: m // 8]
    a.sort()
    k1 = np.concatenate([a, b[::-1]])
    k2 = np.arange(m, dtype=np.uint32)
    t1, t2 = torch.from_numpy(k1.view(np.int64)), i32(k2)
    for jfn, pfn in ((mod._merge_flat, dma_probes_r3.merge_flat),
                     (mod._merge_rowfused, dma_probes_r3.merge_rowfused)):
        w1, w2 = jax.jit(jfn)(jnp.asarray(k1), jnp.asarray(k2))
        g1, g2 = pfn(t1, t2)
        assert np.array_equal(g1.numpy().view(np.uint64), np.asarray(w1))
        assert same_bits(g2, np.asarray(w2))
    assert (np.diff(g1.numpy()) >= 0).all()


def test_d4_inputs_are_the_scripts(jax_dma, capsys):
    """The JAX script's D4 at a small n prints ok=True, and the port draws
    the same keys."""
    mod, _ = jax_dma
    n = 1 << 14
    mod.d4_merge_variants(n)
    assert "ok=True" in capsys.readouterr().out
    k1, k2, half = dma_probes_r3.merge_inputs(n, torch.device("cpu"))
    rng = np.random.default_rng(0)
    a = np.sort(rng.integers(0, 2 ** 63, n // 2, np.uint64))
    b = np.sort(rng.integers(0, 2 ** 63, n // 2, np.uint64))
    assert half == n // 2
    assert np.array_equal(k1.numpy().view(np.uint64),
                          np.concatenate([a, b[::-1]]))
    assert np.array_equal(k2.numpy(), np.arange(n))


def test_entry_point_on_the_cpu(capsys):
    """``dma_probes_r3 16 --device cpu``: every line says ok=True and names
    the host clock, in the JAX script's order, and no wrapper counts a
    launch (no kernel ran)."""
    before = tuple(w.launches for w in WRAPPERS)
    dma_probes_r3.main(["16", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device ready")
    probes = lines[1:]
    assert [ln.split()[0] for ln in probes] == (
        ["D1", "D2", "D1", "D1", "D3", "D3", "D4", "D4"])
    assert [ln.split("rows/copy=")[1].split()[0] for ln in probes[:4]] == [
        "512", "512", "64", "8"]
    assert "2^20" in probes[4] and "2^16" in probes[5]
    assert "2^16" in probes[6] and "2^14" in probes[7]
    for ln in probes:
        assert "ok=True" in ln and ln.endswith(_common.card_line(
            torch.device("cpu"))), ln
    assert before == tuple(w.launches for w in WRAPPERS)
    with pytest.raises(ValueError):
        dma_probes_r3.run(15, device="cpu")


def test_a_failing_probe_raises(monkeypatch, capsys):
    """Unlike the JAX script, which prints a failure and goes on."""
    monkeypatch.setattr(cpd, "plain_lane_gather",
                        lambda tab, idx: torch.zeros_like(idx))
    for name in ("d1_pipelined_copy", "d4_merge_variants"):
        monkeypatch.setattr(dma_probes_r3, name, lambda *a: {
            "dynamic": True})
    with pytest.raises(RuntimeError, match="probe failed: D3"):
        dma_probes_r3.run(16, device="cpu")
    assert "ok=False" in capsys.readouterr().out


def test_the_turns_need_a_card():
    """The turns time the card: without one they raise and fall back to
    nothing, the host's clock included."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the turns")
    from kmer_hasher_tpu_torch.probes import turns
    with pytest.raises(RuntimeError, match="CUDA card"):
        turns.run()
