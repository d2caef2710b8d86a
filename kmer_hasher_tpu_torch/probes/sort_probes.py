"""Probes for the merge-sort kernel's design (PyTorch port of
``tools/chip_probes/sort_probes.py``).

    python -m kmer_hasher_tpu_torch.probes.sort_probes [log_n] [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``log_n`` defaults to 24.
One line per answer, each with ``ok=`` and the card's name and power limit:

  E1   copy bandwidth of a hand-written kernel (P1) over 2^log_n elements;
  E2   copies of 2^13 elements from offsets only the device knows (P2), at
       offset granules of 1,024, 8 and 1 element: 64 tiles as the TPU probe
       ran them (a time that is mostly the launch), and 2^log_n / 2^13 tiles
       from distinct offsets all over x;
  E3   rotation of a [64, 128] tile along its rows by a shift read on the
       device (P3): one tile with shift 5, and 2^log_n / 2^13 tiles;
  E3b  the same tile flattened, shift 777 (P4);
  E4   two-key row sorts of [2^log_n / L, L] for L = 2^13, 2^15, 2^17
       through ``_common.lex_sort`` (phase 1 of the JAX merge sort);
  E5   the flat two-key sort, and a flat one-key stable ``torch.sort``.

E4 and E5 launch no kernel of the port. A probe that fails raises: here a
failure is a fault, not data.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..index.position_index import resolve_device
from . import cuda_probes as cp
from ._common import card_line, lex_sort, timeit

TILE = (64, 128)  # the rotated tile: 2^13 elements
SHIFT_ROWS, SHIFT_FLAT = 5, 777
GRANULES = (1024, 8, 1)
REF_TILES = 64
ROW_LOGS = (13, 15, 17)


def _report(line: str, ok: bool, card: str) -> None:
    print(f"{line} | {card}", flush=True)
    if not ok:
        raise RuntimeError(f"probe failed: {line}")


def _arange32(n: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def reference_offsets(n: int, granule: int) -> np.ndarray:
    """The TPU probe's 64 offsets: multiples of ``granule`` below n - CH
    from ``np.random.default_rng(0)``."""
    return (np.random.default_rng(0).integers(
        0, (n - cp.CH) // granule, size=REF_TILES) * granule).astype(np.int32)


def spread_offsets(n: int, granule: int, tiles: int) -> np.ndarray:
    """``tiles`` distinct multiples of ``granule`` in [0, n - CH], one from
    each of ``tiles`` equal strata of that range, in shuffled order."""
    rng = np.random.default_rng(granule)
    slots = (n - cp.CH) // granule + 1  # offsets 0, g, ..., <= n - CH
    if tiles > slots:
        raise ValueError(f"no {tiles} distinct offsets at granule {granule}")
    edges = (np.arange(tiles + 1, dtype=np.int64) * slots) // tiles
    pick = edges[:-1] + rng.integers(0, np.diff(edges))
    return (rng.permutation(pick) * granule).astype(np.int32)


def e1_copy_bandwidth(n: int, dev: torch.device, card: str) -> dict:
    x = _arange32(n, dev).reshape(-1, 128)
    ok = bool(torch.equal(cp.copy(x), x))
    dt = timeit(lambda: cp.copy(x), dev)
    gbs = 2 * 4 * n / dt / 1e9
    _report(f"E1 copy: ok={ok} {dt * 1e3:.4f} ms for 2^{n.bit_length() - 1} "
            f"u32 -> {gbs:.0f} GB/s", ok, card)
    return {"ok": ok, "ms": dt * 1e3, "gbs": gbs}


def e2_dynamic_dma(n: int, granule: int, dev: torch.device, card: str
                   ) -> dict:
    x = _arange32(n, dev)
    out = {"granule": granule}
    for name, offs in (("ref", reference_offsets(n, granule)),
                       ("all", spread_offsets(n, granule, n // cp.CH))):
        tiles = offs.shape[0]
        offs_d = torch.from_numpy(offs).to(dev)
        got = cp.dyn_copy(x, offs_d)
        # x is arange: window t must hold offs[t], offs[t] + 1, ...
        ok = bool(torch.equal(got.reshape(tiles, cp.CH),
                              offs_d[:, None] + x[: cp.CH]))
        dt = timeit(lambda: cp.dyn_copy(x, offs_d), dev)
        gbs = 2 * 4 * tiles * cp.CH / dt / 1e9
        _report(f"E2 dyn-copy granule={granule} tiles={tiles}: ok={ok} "
                f"{dt * 1e3:.4f} ms ({gbs:.0f} GB/s)", ok, card)
        out[name] = {"ok": ok, "tiles": tiles, "ms": dt * 1e3, "gbs": gbs}
    return out


def _roll_probe(name: str, fn, shift: int, flat: bool, n: int,
                dev: torch.device, card: str) -> dict:
    n_tile = TILE[0] * TILE[1]
    x = _arange32(n_tile, dev).reshape(TILE)
    got = fn(x, torch.tensor([shift], dtype=torch.int32, device=dev))
    ref = np.arange(n_tile, dtype=np.int32).reshape(TILE)
    want = (np.roll(ref.reshape(-1), shift).reshape(TILE) if flat
            else np.roll(ref, shift, axis=0))
    ok = bool((got.cpu().numpy() == want).all())
    # the timing: every tile of 2^log_n elements, each with its own shift
    tiles = max(1, n // n_tile)
    xs = _arange32(tiles * n_tile, dev).reshape((tiles,) + TILE)
    shifts = torch.from_numpy(np.random.default_rng(shift).integers(
        -3 * n_tile, 3 * n_tile, size=tiles).astype(np.int32)).to(dev)
    dt = timeit(lambda: fn(xs, shifts), dev)
    gbs = 2 * 4 * tiles * n_tile / dt / 1e9
    _report(f"{name}: ok={ok} (shift {shift}); {tiles} tiles, a shift each: "
            f"{dt * 1e3:.4f} ms ({gbs:.0f} GB/s)", ok, card)
    return {"ok": ok, "tiles": tiles, "ms": dt * 1e3, "gbs": gbs}


def e3_traced_roll(n: int, dev: torch.device, card: str) -> dict:
    return _roll_probe("E3 device-shift roll(axis=0)", cp.roll_rows,
                       SHIFT_ROWS, False, n, dev, card)


def e3b_traced_roll_flat(n: int, dev: torch.device, card: str) -> dict:
    return _roll_probe("E3b device-shift roll(flat)", cp.roll_flat,
                       SHIFT_FLAT, True, n, dev, card)


def _sort_keys(n: int, dev: torch.device):
    """(random non-negative int64 keys, the row number as payload)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k1 = torch.randint(0, 2 ** 63 - 1, (n,), generator=gen, device=dev)
    return k1, _arange32(n, dev)


def _rows_sorted(k: torch.Tensor, p: torch.Tensor) -> bool:
    """Every row ascends by (key, payload)."""
    dk, dp = k[..., 1:] - k[..., :-1], p[..., 1:] - p[..., :-1]
    return bool(((dk > 0) | ((dk == 0) & (dp >= 0))).all())


def e4_batched_row_sort(n: int, dev: torch.device, card: str) -> List[dict]:
    k1, k2 = _sort_keys(n, dev)
    out = []
    for log_l in ROW_LOGS:
        L = min(1 << log_l, n)
        rows = (k1.reshape(-1, L), k2.reshape(-1, L))
        ok = _rows_sorted(*lex_sort(*rows))
        dt = timeit(lambda: lex_sort(*rows), dev, iters=2)
        _report(f"E4 row sort [{n // L}, 2^{L.bit_length() - 1}] (i64,u32): "
                f"ok={ok} {dt * 1e3:.3f} ms ({dt / n * 1e9:.3f} ns/elem)",
                ok, card)
        out.append({"ok": ok, "L": L, "ms": dt * 1e3})
    return out


def e5_flat_sort(n: int, dev: torch.device, card: str) -> List[dict]:
    k1, k2 = _sort_keys(n, dev)

    def one_key():
        s, order = torch.sort(k1, stable=True)
        return s, k2[order]

    out = []
    for name, fn in (("2key", lambda: lex_sort(k1, k2)),
                     ("1key-stable", one_key)):
        ok = _rows_sorted(*fn())
        dt = timeit(fn, dev, iters=2)
        _report(f"E5 flat sort {name} 2^{n.bit_length() - 1}: ok={ok} "
                f"{dt * 1e3:.3f} ms ({dt / n * 1e9:.3f} ns/elem)", ok, card)
        out.append({"ok": ok, "name": name, "ms": dt * 1e3})
    return out


def run(log_n: int = 24, device="cuda") -> dict:
    """Every probe in turn at n = 2^log_n on ``device``; the results by
    probe. Raises at the first probe that fails."""
    if not 14 <= log_n <= 30:
        raise ValueError("log_n must be in 14..30")
    dev = resolve_device(device)
    n = 1 << log_n
    card = card_line(dev)
    print(f"device ready: {card}", flush=True)
    return {
        "E1": e1_copy_bandwidth(n, dev, card),
        "E2": [e2_dynamic_dma(n, g, dev, card) for g in GRANULES],
        "E3": e3_traced_roll(n, dev, card),
        "E3b": e3b_traced_roll_flat(n, dev, card),
        "E4": e4_batched_row_sort(n, dev, card),
        "E5": e5_flat_sort(n, dev, card),
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_n", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.log_n, args.device)


if __name__ == "__main__":
    main()
