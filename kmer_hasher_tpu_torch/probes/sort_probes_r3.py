"""Round-3 probes of the sort's design (PyTorch port of
``tools/chip_probes/sort_probes_r3.py``).

    python -m kmer_hasher_tpu_torch.probes.sort_probes_r3 [log_n] [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``log_n`` defaults to 24.
One line per answer, each with ``ok=`` and the card's name and power limit,
in the JAX script's order:

  R1   stable sorts by a 32-bit key with one and with two 32-bit payload
       lanes, and the 64-bit-key control (``torch.sort(stable=True)`` and
       gathers): what one pass of a two-pass LSD sort would cost;
  R5   the log2(L) compare-exchange stages that clean bitonic rows
       [2^log_n / L, L], L = 2^13 and 2^15, in plain tensor operations,
       beside the full row sort (``_common.lex_sort``);
  R2   row windows copied between offsets only the device knows, in step
       order (P5), 512 and 8 rows a copy: the TPU probe's 64 steps, whose
       write windows overlap, and every window of x once;
  R2b  a gather of 2 KB records (P6): 4,096 records as the TPU probe ran
       them, and every record of x once, shuffled;
  R4   a gather from a 1,024-entry table in shared memory (P8) over 2^22
       indices and over 2^log_n, beside P1's copy of as many elements;
  R3   P2's copies through ``cp.async`` (P7) at offset granules 1,024 and 1,
       64 tiles and 2^log_n / 2^13 tiles, beside P2's own time.

R1 and R5 launch no kernel of the port. A probe that fails raises.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..index.position_index import resolve_device
from . import cuda_probes as cp
from . import cuda_probes_r3 as cp3
from ._common import card_line, lex_sort, timeit
from .sort_probes import (_arange32, _report, _rows_sorted, reference_offsets,
                          spread_offsets)

ROWS_PER_COPY = (512, 8)
REF_STEPS = 64
REF_RECORDS = 4096
GATHER_REF_LOG_N = 22
GRANULES = (1024, 1)
CLEAN_ROW_LOGS = (13, 15)
_FLIP = -(1 << 31)  # xor: a u32's bits as an int32 of the same order
_FLIP64 = -(1 << 63)  # the same for a u64's bits in an int64


# -- R1 -----------------------------------------------------------------------

def r1_inputs(n: int):
    """(key, payload 1, payload 2) as the JAX script draws them: uint32
    numpy arrays from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    k32 = rng.integers(0, 2 ** 32, n, np.uint64).astype(np.uint32)
    p1 = np.arange(n, dtype=np.uint32)
    p2 = rng.integers(0, 2 ** 32, n, np.uint64).astype(np.uint32)
    return k32, p1, p2


def sort_u32_key(k: torch.Tensor, *pays: torch.Tensor):
    """Stable sort by a 32-bit unsigned key (int32 tensors carrying uint32
    bits) with any number of payload lanes: (key, *payloads) sorted."""
    s, order = torch.sort(k ^ _FLIP, stable=True)
    return (s ^ _FLIP, *(p[order] for p in pays))


def sort_u64_key(k: torch.Tensor, a: torch.Tensor):
    """The control: stable sort by the 64-bit key ``(k << 32) | a`` with
    payload ``a``: (key as int64 carrying the uint64 bits, payload)."""
    kk = (k.to(torch.int64) << 32) | (a.to(torch.int64) & 0xFFFFFFFF)
    s, order = torch.sort(kk ^ _FLIP64, stable=True)
    return s ^ _FLIP64, a[order]


def _u32_ascending(k: torch.Tensor, a: torch.Tensor) -> bool:
    """Keys ascend as unsigned, and the first payload within equal keys."""
    return _rows_sorted((k ^ _FLIP).to(torch.int64),
                        (a ^ _FLIP).to(torch.int64))


def r1_u32_key_sorts(n: int, dev: torch.device, card: str) -> List[dict]:
    k32, p1, p2 = (torch.from_numpy(a.view(np.int32)).to(dev)
                   for a in r1_inputs(n))
    out = []
    for name, fn in (
            ("u32key+1pay", lambda: sort_u32_key(k32, p1)),
            ("u32key+2pay", lambda: sort_u32_key(k32, p1, p2)),
            ("u64key+1pay (control)", lambda: sort_u64_key(k32, p1))):
        got = fn()
        if got[0].dtype == torch.int64:
            flipped = got[0] ^ _FLIP64
            ok = bool((flipped[1:] >= flipped[:-1]).all())
        else:
            ok = _u32_ascending(got[0], got[1])
        dt = timeit(fn, dev, iters=2)
        _report(f"R1 {name} 2^{n.bit_length() - 1}: ok={ok} "
                f"{dt * 1e3:.3f} ms ({dt / n * 1e9:.3f} ns/elem)", ok, card)
        out.append({"ok": ok, "name": name, "ms": dt * 1e3})
    return out


# -- R5 -----------------------------------------------------------------------

def bitonic_clean(k1: torch.Tensor, k2: torch.Tensor, rows: int, length: int):
    """The log2(length) compare-exchange stages over [rows, length]: every
    bitonic row of (key, payload) comes out ascending by key. The payload
    follows its key; ties keep the lower half's element first."""
    k1 = k1.reshape(rows, length)
    k2 = k2.reshape(rows, length)
    stride = length // 2
    while stride >= 1:
        v1 = k1.reshape(rows, -1, 2, stride)
        v2 = k2.reshape(rows, -1, 2, stride)
        x1, y1 = v1[:, :, 0, :], v1[:, :, 1, :]
        x2, y2 = v2[:, :, 0, :], v2[:, :, 1, :]
        le = x1 <= y1
        k1 = torch.stack([torch.where(le, x1, y1), torch.where(le, y1, x1)],
                         2).reshape(rows, length)
        k2 = torch.stack([torch.where(le, x2, y2), torch.where(le, y2, x2)],
                         2).reshape(rows, length)
        stride //= 2
    return k1, k2


def bitonic_rows(n: int, length: int, dev: torch.device):
    """(keys [n] int64, payload [n] int32): rows of ``length`` whose first
    half ascends and second half descends, random non-negative keys from a
    seeded generator on ``dev``, the row number as payload."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    half = torch.randint(0, 2 ** 63 - 1, (2, n // length, length // 2),
                         generator=gen, device=dev)
    a = torch.sort(half[0], dim=-1).values
    b = torch.sort(half[1], dim=-1, descending=True).values
    return torch.cat([a, b], -1).reshape(-1), _arange32(n, dev)


def r5_bitonic_clean_rows(n: int, dev: torch.device, card: str) -> List[dict]:
    out = []
    for log_l in CLEAN_ROW_LOGS:
        length = min(1 << log_l, n)
        rows = n // length
        k1, k2 = bitonic_rows(n, length, dev)
        got = bitonic_clean(k1, k2, rows, length)
        ok = bool((got[0][:, 1:] >= got[0][:, :-1]).all()) and bool(
            torch.equal(k1[got[1].reshape(-1).long()], got[0].reshape(-1)))
        dt = timeit(lambda: bitonic_clean(k1, k2, rows, length), dev, iters=2)
        full = (k1.reshape(rows, length), k2.reshape(rows, length))
        dt_sort = timeit(lambda: lex_sort(*full), dev, iters=2)
        _report(f"R5 bitonic clean rows [{rows}, 2^{length.bit_length() - 1}]"
                f" (i64,u32): ok={ok} {dt * 1e3:.3f} ms "
                f"({dt / n * 1e9:.3f} ns/elem); the full row sort "
                f"{dt_sort * 1e3:.3f} ms", ok, card)
        out.append({"ok": ok, "L": length, "ms": dt * 1e3,
                    "sort_ms": dt_sort * 1e3})
    return out


# -- R2, R2b: rows ------------------------------------------------------------

def reference_row_offsets(rows: int, r: int, count: int) -> np.ndarray:
    """The TPU probes' row offsets: ``count`` draws below rows - r from
    ``np.random.default_rng(0)``."""
    return np.random.default_rng(0).integers(
        0, rows - r, size=count).astype(np.int32)


def spread_row_offsets(rows: int, r: int) -> np.ndarray:
    """Every window of ``r`` rows of x once, in shuffled order: as the read
    offsets they cover x, and reversed, as the write offsets, the output,
    so no two windows meet."""
    return (np.random.default_rng(r).permutation(rows // r) * r).astype(
        np.int32)


def sequential_source_rows(rows: int, offs: np.ndarray, r: int) -> np.ndarray:
    """numpy's statement of P5 on row numbers: for each row of the output
    the row of x that stands there after the steps ran in order, -1 where
    no step wrote."""
    src = np.full(rows, -1, np.int64)
    steps = len(offs)
    for t in range(steps):
        a, d = int(offs[t]), int(offs[steps - 1 - t])
        if 0 <= a <= rows - r and 0 <= d <= rows - r:
            src[d: d + r] = np.arange(a, a + r)
    return src


def r2_dyn_dma_2d(n: int, r: int, dev: torch.device, card: str) -> dict:
    rows = n // cp3.COLS
    x = _arange32(n, dev).reshape(rows, cp3.COLS)
    cols = x[0]
    out = {"rows_per_copy": r}
    for name, offs in (("ref", reference_row_offsets(rows, r, REF_STEPS)),
                       ("all", spread_row_offsets(rows, r))):
        steps = offs.shape[0]
        offs_d = torch.from_numpy(offs).to(dev)
        got = cp3.dyn_copy_2d(x, offs_d, r)
        # x is arange: a row copied from row s holds s * 128 + column
        src = torch.from_numpy(sequential_source_rows(rows, offs, r)).to(dev)
        want = torch.where(src[:, None] >= 0,
                           (src[:, None] * cp3.COLS + cols).to(torch.int32),
                           0)
        ok = bool(torch.equal(got, want))
        written = int((src >= 0).sum())
        dt = timeit(lambda: cp3.dyn_copy_2d(x, offs_d, r), dev)
        gbs = 2 * 4 * steps * r * cp3.COLS / dt / 1e9
        _report(f"R2 2-D dyn-copy rows/copy={r} steps={steps}: ok={ok} "
                f"({written} of {rows} rows written) {dt * 1e3:.4f} ms "
                f"({gbs:.0f} GB/s, the owner pass included)",
                ok, card)
        out[name] = {"ok": ok, "steps": steps, "ms": dt * 1e3, "gbs": gbs,
                     "rows_written": written}
    return out


def r2b_small_dma_rate(n: int, dev: torch.device, card: str) -> dict:
    rows = n // cp3.COLS
    r = cp3.SMALL_ROWS
    x = _arange32(n, dev).reshape(rows, cp3.COLS)
    out = {}
    for name, offs in (("ref", reference_row_offsets(rows, r, REF_RECORDS)),
                       ("all", spread_row_offsets(rows, r))):
        n_rec = offs.shape[0]
        offs_d = torch.from_numpy(offs).to(dev)
        got = cp3.small_copy(x, offs_d)
        first = offs_d.to(torch.int64) * cp3.COLS  # x is arange
        ok = bool(torch.equal(
            got.reshape(n_rec, -1),
            (first[:, None] + torch.arange(r * cp3.COLS, device=dev)
             ).to(torch.int32)))
        dt = timeit(lambda: cp3.small_copy(x, offs_d), dev)
        gbs = 2 * 4 * r * cp3.COLS * n_rec / dt / 1e9
        _report(f"R2b small dyn-copy (2KB each): ok={ok} {dt * 1e3:.4f} ms "
                f"for {n_rec} -> {n_rec / dt / 1e6:.2f} M transfers/s "
                f"({gbs:.0f} GB/s)", ok, card)
        out[name] = {"ok": ok, "records": n_rec, "ms": dt * 1e3, "gbs": gbs,
                     "transfers_per_s": n_rec / dt}
    return out


# -- R4 -----------------------------------------------------------------------

def r4_smem_gather(n: int, dev: torch.device, card: str) -> dict:
    tab = (_arange32(cp3.TABLE, dev) * 7).reshape(-1, cp3.COLS)
    idx_h = np.random.default_rng(0).integers(
        0, cp3.TABLE, size=n, dtype=np.int32)
    idx = torch.from_numpy(idx_h).to(dev).reshape(-1, cp3.COLS)
    got = cp3.smem_gather(tab, idx)
    ok = bool(torch.equal(got, idx * 7))
    dt = timeit(lambda: cp3.smem_gather(tab, idx), dev)
    dt_copy = timeit(lambda: cp.copy(idx), dev)
    _report(f"R4 shared-memory gather (table 2^10) 2^{n.bit_length() - 1}: "
            f"ok={ok} {dt * 1e3:.4f} ms ({dt / n * 1e9:.4f} ns/elem, "
            f"{8 * n / dt / 1e9:.0f} GB/s); P1's copy of as many elements "
            f"{dt_copy * 1e3:.4f} ms: the gather reaches "
            f"{dt_copy / dt:.1%} of its rate", ok, card)
    return {"ok": ok, "n": n, "ms": dt * 1e3, "copy_ms": dt_copy * 1e3}


# -- R3 -----------------------------------------------------------------------

def r3_dyn_dma_1d(n: int, granule: int, dev: torch.device, card: str) -> dict:
    x = _arange32(n, dev)
    out = {"granule": granule}
    for name, offs in (("ref", reference_offsets(n, granule)),
                       ("all", spread_offsets(n, granule, n // cp.CH))):
        tiles = offs.shape[0]
        offs_d = torch.from_numpy(offs).to(dev)
        got = cp3.async_copy(x, offs_d)
        ok = bool(torch.equal(got.reshape(tiles, cp.CH),
                              offs_d[:, None] + x[: cp.CH]))
        dt = timeit(lambda: cp3.async_copy(x, offs_d), dev)
        dt_p2 = timeit(lambda: cp.dyn_copy(x, offs_d), dev)
        gbs = 2 * 4 * tiles * cp.CH / dt / 1e9
        _report(f"R3 1-D dyn-copy (cp.async) granule={granule} "
                f"tiles={tiles}: ok={ok} {dt * 1e3:.4f} ms ({gbs:.0f} GB/s); "
                f"P2 (plain loads) {dt_p2 * 1e3:.4f} ms", ok, card)
        out[name] = {"ok": ok, "tiles": tiles, "ms": dt * 1e3, "gbs": gbs,
                     "p2_ms": dt_p2 * 1e3}
    return out


def run(log_n: int = 24, device="cuda") -> dict:
    """Every probe in turn at n = 2^log_n on ``device``; the results by
    probe. Raises at the first probe that fails."""
    if not 17 <= log_n <= 30:
        raise ValueError("log_n must be in 17..30")
    dev = resolve_device(device)
    n = 1 << log_n
    card = card_line(dev)
    print(f"device ready: {card}", flush=True)
    return {
        "R1": r1_u32_key_sorts(n, dev, card),
        "R5": r5_bitonic_clean_rows(n, dev, card),
        "R2": [r2_dyn_dma_2d(n, r, dev, card) for r in ROWS_PER_COPY],
        "R2b": r2b_small_dma_rate(n, dev, card),
        "R4": [r4_smem_gather(m, dev, card)
               for m in (1 << GATHER_REF_LOG_N, n)],
        "R3": [r3_dyn_dma_1d(n, g, dev, card) for g in GRANULES],
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_n", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.log_n, args.device)


if __name__ == "__main__":
    main()
