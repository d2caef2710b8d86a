"""The plain versions of the probe kernels P1–P4 against the JAX package's
Pallas probes themselves, bitwise (they move 32-bit elements: no tolerance).

``tools/chip_probes/sort_probes.py`` runs here unedited: ``pallas_call`` is
wrapped to pass ``interpret=True`` and to record every call's inputs and
output as numpy, and the probe functions run under ``jax.disable_jit()``.
The recorded inputs then go through the port's plain versions. Edge cases
are held against numpy, and the port's entry point runs on the CPU."""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kmer_hasher_tpu_torch.probes import _common, cuda_probes as cp
from kmer_hasher_tpu_torch.probes import sort_probes

REPO = pathlib.Path(__file__).resolve().parent.parent


def load_recording(monkeypatch, script: str):
    """(the JAX probe script ``tools/chip_probes/<script>`` as a module, the
    list its pallas calls are recorded in). ``pallas_call`` is wrapped to
    pass ``interpret=True`` and to record every call's inputs and output as
    numpy. ``test_torch_probes_r3.py`` loads the round-3 script with it."""
    calls = []
    real = pl.pallas_call

    def recording(kernel, *args, **kw):
        fn = real(kernel, *args, interpret=True, **kw)

        def run(*inputs):
            out = fn(*inputs)
            calls.append(([np.asarray(x) for x in inputs], np.asarray(out)))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", recording)
    spec = importlib.util.spec_from_file_location(
        "jax_" + script.removesuffix(".py"),
        REPO / "tools" / "chip_probes" / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, calls


@pytest.fixture
def jax_probes(monkeypatch):
    """(the JAX probe module, the list its pallas calls are recorded in)."""
    return load_recording(monkeypatch, "sort_probes.py")


def i32(a: np.ndarray) -> torch.Tensor:
    """A numpy array of 32-bit elements as the port's int32 tensor."""
    return torch.from_numpy(np.array(a).view(np.int32))  # a writable copy


def same_bits(t: torch.Tensor, a: np.ndarray) -> bool:
    return t.dtype == torch.int32 and np.array_equal(
        t.numpy().view(np.uint32), a.view(np.uint32))


def test_p1_plain_equals_the_pallas_copy(jax_probes, capsys):
    mod, calls = jax_probes
    with jax.disable_jit():
        mod.e1_copy_bandwidth(1 << 20)
    (x,), out = calls[0]
    assert x.shape == (1 << 13, 128) and np.array_equal(out, x)
    assert same_bits(cp.plain_copy(i32(x)), out)
    assert same_bits(cp.copy(i32(x)), out)  # a CPU tensor: the plain version
    assert "E1 copy" in capsys.readouterr().out


@pytest.mark.parametrize("granule", [1024, 8, 1])
def test_p2_plain_equals_the_pallas_dynamic_copy(jax_probes, granule, capsys):
    mod, calls = jax_probes
    with jax.disable_jit():
        mod.e2_dynamic_dma(1 << 20, granule)
    (offs, x), out = calls[0]
    assert offs.shape == (64,) and offs.dtype == np.int32
    assert (offs % granule == 0).all() and out.shape == (64 * cp.CH,)
    got = cp.plain_dyn_copy(i32(x), torch.from_numpy(offs))
    assert same_bits(got, out)
    assert same_bits(cp.dyn_copy(i32(x), torch.from_numpy(offs)), out)
    # the port's entry draws the same 64 offsets
    assert np.array_equal(sort_probes.reference_offsets(1 << 20, granule),
                          offs)
    assert "ok=True" in capsys.readouterr().out


def test_p3_plain_equals_the_pallas_row_roll(jax_probes, capsys):
    mod, calls = jax_probes
    with jax.disable_jit():
        mod.e3_traced_roll()
    (sh, x), out = calls[0]
    assert x.shape == sort_probes.TILE and sh.tolist() == [5]
    assert same_bits(cp.plain_roll_rows(i32(x), torch.from_numpy(sh)), out)
    assert same_bits(cp.roll_rows(i32(x), torch.from_numpy(sh)), out)
    assert "ok=True" in capsys.readouterr().out


def test_p4_plain_equals_the_pallas_flat_roll(jax_probes, capsys):
    mod, calls = jax_probes
    with jax.disable_jit():
        mod.e3b_traced_roll_flat()
    (sh, x), out = calls[0]
    assert sh.tolist() == [777]
    assert same_bits(cp.plain_roll_flat(i32(x), torch.from_numpy(sh)), out)
    assert same_bits(cp.roll_flat(i32(x), torch.from_numpy(sh)), out)
    assert "ok=True" in capsys.readouterr().out


@pytest.mark.parametrize("flat", [False, True])
def test_roll_edge_shifts_against_numpy(flat):
    """Shift 0, 1, N - 1, N, above N and negative, one per tile of a batch
    and of a batch of batches, follow np.roll."""
    rng = np.random.default_rng(3)
    rows, cols = 8, 16
    n = rows * cols if flat else rows
    shifts = np.array([0, 1, n - 1, n, n + 3, 5 * n + 2, -1, -n - 5,
                       2 ** 31 - 1, -2 ** 31], np.int64)
    x = rng.integers(0, 2 ** 32, size=(len(shifts), rows, cols),
                     dtype=np.uint32)
    want = np.stack([
        np.roll(t.reshape(-1), s).reshape(t.shape) if flat
        else np.roll(t, s, axis=0) for t, s in zip(x, shifts.tolist())])
    fn = cp.roll_flat if flat else cp.roll_rows
    sh = torch.from_numpy(shifts.astype(np.int32))
    assert same_bits(fn(i32(x), sh), want)
    nested = fn(i32(x).reshape(2, 5, rows, cols), sh.reshape(2, 5))
    assert same_bits(nested.reshape(-1, rows, cols), want)
    with pytest.raises(TypeError):
        fn(i32(x), sh[:3])
    with pytest.raises(TypeError):
        fn(i32(x), sh.long())


def test_dyn_copy_edge_offsets_against_numpy():
    """Offsets 0 and n - CH (the last window that fits), repeats and odd
    offsets; what the wrapper refuses."""
    rng = np.random.default_rng(4)
    n = 3 * cp.CH + 17
    x = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    offs = np.array([0, n - cp.CH, 1, 3, 4099, 4099, n - cp.CH - 1], np.int32)
    want = np.concatenate([x[o: o + cp.CH] for o in offs])
    assert same_bits(cp.dyn_copy(i32(x), torch.from_numpy(offs)), want)
    empty = cp.dyn_copy(i32(x), torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0,)
    with pytest.raises(ValueError):
        cp.dyn_copy(i32(x[: cp.CH - 1]), torch.from_numpy(offs))
    with pytest.raises(TypeError):
        cp.dyn_copy(i32(x), torch.from_numpy(offs).long())
    with pytest.raises(ValueError):
        cp.dyn_copy(i32(x).reshape(1, -1), torch.from_numpy(offs))


@pytest.mark.parametrize("granule", [1024, 8, 1])
def test_spread_offsets_are_distinct_multiples_inside_x(granule):
    n = 1 << 18
    offs = sort_probes.spread_offsets(n, granule, n // cp.CH)
    assert offs.dtype == np.int32 and len(set(offs.tolist())) == n // cp.CH
    assert (offs % granule == 0).all()
    assert offs.min() >= 0 and offs.max() <= n - cp.CH
    if granule == 1:
        assert (offs % 4 != 0).any()  # windows off the 16-byte boundary
    with pytest.raises(ValueError):
        sort_probes.spread_offsets(4 * cp.CH, 8192, 5)


def test_entry_point_on_the_cpu(capsys):
    """``sort_probes 20 --device cpu``: every line says ok=True and names
    the host clock, and no wrapper counts a launch (no kernel ran)."""
    before = (cp.copy.launches, cp.dyn_copy.launches, cp.roll_rows.launches,
              cp.roll_flat.launches)
    sort_probes.main(["20", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device ready")
    probes = lines[1:]
    assert [ln.split()[0] for ln in probes] == (
        ["E1"] + ["E2"] * 6 + ["E3", "E3b"] + ["E4"] * 3 + ["E5"] * 2)
    for ln in probes:
        assert "ok=True" in ln and ln.endswith(_common.card_line(
            torch.device("cpu"))), ln
    assert before == (cp.copy.launches, cp.dyn_copy.launches,
                      cp.roll_rows.launches, cp.roll_flat.launches)
    res = sort_probes.run(14, device="cpu")
    assert res["E1"]["ok"] and all(g["all"]["tiles"] == 2 for g in res["E2"])
    with pytest.raises(ValueError):
        sort_probes.run(12, device="cpu")


def test_a_failing_probe_raises(monkeypatch, capsys):
    """Unlike the JAX script, which prints a failure and goes on."""
    monkeypatch.setattr(cp, "plain_copy", lambda x: x + 1)
    with pytest.raises(RuntimeError, match="probe failed: E1"):
        sort_probes.run(14, device="cpu")
    assert "ok=False" in capsys.readouterr().out


def test_timer_and_card_line_on_the_cpu():
    cpu = torch.device("cpu")
    calls = []
    assert _common.timeit(lambda: calls.append(1), cpu) >= 0.0
    assert len(calls) == _common.calls_per_timing(cpu) == 1
    assert "host clock" in _common.card_line(cpu)
