"""Round-3 DMA probes (PyTorch port of ``tools/chip_probes/dma_probes_r3.py``):
how far copies kept in flight reach, and a 2-D gather inside a kernel.

    python -m kmer_hasher_tpu_torch.probes.dma_probes_r3 [log_n] [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``log_n`` defaults to 24.
One line per answer, each with ``ok=`` and the card's name and power limit,
in the JAX script's order:

  D1   row windows of R rows copied in step order through a ring of
       shared-memory stages (P9), R = 512, then 64 and 8, offsets from a
       permutation of the windows as the TPU probe drew them;
  D2   the control at R = 512 (P9 with the offsets computed, not read);
  D3   ``out[r, c] = tab[idx[r, c], c]`` with a [1024, 128] table (P10), at
       the TPU probe's 2^20 elements and at 2^log_n, beside P1's copy of the
       indices;
  D4   a bitonic (u64 key, u32 payload) array of 2^log_n and 2^log_n / 4
       elements merged by the log2(M) compare-exchange stages, flat and with
       the strides below 2^13 on a row view, in plain tensor operations,
       beside B3 on the same two sorted halves.

Each line has the kernel's time, its plain version's and, where one PyTorch
call computes the same function, that call's; the D1/D2 lines also P5's
time for the same call. ``ok`` holds each kernel's whole output against its
plain version and a closed form. D4 launches no kernel of its own. A probe
that fails raises (the JAX script printed a failure and went on).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..index.position_index import resolve_device
from ..ops import cuda_merge
from . import cuda_probes as cp
from . import cuda_probes_dma as cpd
from . import cuda_probes_r3 as cp3
from ._common import card_line, time_once, timeit
from .sort_probes import _arange32, _report
from .sort_probes_r3 import sequential_source_rows

COPY_PROBES = ((512, True), (512, False), (64, True), (8, True))
GATHER_REF_LOG_N = 20  # the TPU probe's fixed element count
ROWFUSED_LOG_TAIL = 13


# -- D1, D2: P9 -----------------------------------------------------------------

def window_offsets(rows: int, r: int) -> np.ndarray:
    """The TPU probe's offsets: a permutation of the rows // r windows from
    ``np.random.default_rng(0)``, times r."""
    tiles = rows // r
    return (np.random.default_rng(0).permutation(tiles) * r).astype(np.int32)


def d1_pipelined_copy(n: int, r: int, dynamic: bool, dev: torch.device,
                      card: str) -> dict:
    rows = n // cp3.COLS
    x = _arange32(n, dev).reshape(rows, cp3.COLS)
    offs_h = window_offsets(rows, r) if dynamic else (
        np.arange(rows // r, dtype=np.int32) * r)
    steps = offs_h.shape[0]
    offs = torch.from_numpy(offs_h).to(dev)
    arg = offs if dynamic else None
    got = cpd.pipelined_copy(x, arg, r)
    want, dt_plain = time_once(lambda: cpd.plain_pipelined_copy(x, arg, r),
                               dev)
    # x is arange: a row copied from row s holds s * 128 + column
    src = torch.from_numpy(sequential_source_rows(rows, offs_h, r)).to(dev)
    closed = torch.where(src[:, None] >= 0,
                         (src[:, None] * cp3.COLS + x[0]).to(torch.int32), 0)
    ok = bool(torch.equal(got, want)) and bool(torch.equal(got, closed))
    del got, want, closed, src
    dt = timeit(lambda: cpd.pipelined_copy(x, arg, r), dev)
    dt_p5 = timeit(lambda: cp3.dyn_copy_2d(x, offs, r), dev)
    # the library call: one gather of whole windows and one scatter, with
    # both int64 window numbers ready (the windows tile x: a permutation)
    blocks_x = x.reshape(steps, -1)
    rd = (offs.to(torch.int64) // r)
    wr = torch.flip(rd, [0])
    lib_out = torch.empty_like(blocks_x)

    def library():
        lib_out[wr] = blocks_x[rd]

    dt_lib = timeit(library, dev)
    gbs = 2 * 4 * steps * r * cp3.COLS / dt / 1e9
    kind = "dyn" if dynamic else "static"
    _report(f"D{1 if dynamic else 2} {kind} pipelined copy rows/copy={r} "
            f"({r * 512} B) steps={steps}: ok={ok} {dt * 1e3:.4f} ms "
            f"({gbs:.0f} GB/s); plain {dt_plain * 1e3:.4f} ms; library "
            f"gather+scatter {dt_lib * 1e3:.4f} ms; P5 {dt_p5 * 1e3:.4f} ms",
            ok, card)
    return {"ok": ok, "rows_per_copy": r, "dynamic": dynamic, "steps": steps,
            "ms": dt * 1e3, "gbs": gbs, "plain_ms": dt_plain * 1e3,
            "library_ms": dt_lib * 1e3, "p5_ms": dt_p5 * 1e3}


# -- D3: P10 --------------------------------------------------------------------

def gather_inputs(n: int, dev: torch.device):
    """(tab, idx) as the TPU probe made them: ``tab`` = 7 x the flat index
    of a [1024, 128] table, ``idx`` [n / 128, 128] uniform in [0, 1024)
    from ``np.random.default_rng(0)``."""
    tab = (_arange32(cpd.TABLE_ROWS * cp3.COLS, dev) * 7).reshape(
        cpd.TABLE_ROWS, cp3.COLS)
    idx = np.random.default_rng(0).integers(
        0, cpd.TABLE_ROWS, size=(n // cp3.COLS, cp3.COLS), dtype=np.int32)
    return tab, torch.from_numpy(idx).to(dev)


def d3_lane_gather(n: int, dev: torch.device, card: str) -> dict:
    tab, idx = gather_inputs(n, dev)
    got = cpd.lane_gather(tab, idx)
    want, dt_plain = time_once(lambda: cpd.plain_lane_gather(tab, idx), dev)
    closed = (idx * cp3.COLS + _arange32(cp3.COLS, dev)) * 7
    ok = bool(torch.equal(got, want)) and bool(torch.equal(got, closed))
    del got, want, closed
    dt = timeit(lambda: cpd.lane_gather(tab, idx), dev)
    idx64 = idx.to(torch.int64)
    dt_lib = timeit(lambda: torch.gather(tab, 0, idx64), dev)
    dt_copy = timeit(lambda: cp.copy(idx), dev)
    _report(f"D3 lane gather (tab [{cpd.TABLE_ROWS},{cp3.COLS}]) "
            f"2^{n.bit_length() - 1}: ok={ok} {dt * 1e3:.4f} ms "
            f"({dt / n * 1e9:.4f} ns/elem, {8 * n / dt / 1e9:.0f} GB/s); "
            f"plain {dt_plain * 1e3:.4f} ms; torch.gather "
            f"{dt_lib * 1e3:.4f} ms; P1's copy of as many elements "
            f"{dt_copy * 1e3:.4f} ms: the gather reaches {dt_copy / dt:.1%} "
            f"of its rate", ok, card)
    return {"ok": ok, "n": n, "ms": dt * 1e3, "plain_ms": dt_plain * 1e3,
            "library_ms": dt_lib * 1e3, "copy_ms": dt_copy * 1e3}


# -- D4: plain merge networks ---------------------------------------------------

def _exchange(k1: torch.Tensor, k2: torch.Tensor, shape, dim: int):
    """One compare-exchange stage on a view ``shape`` whose axis ``dim``
    (of size 2) pairs the elements; the payload follows its key and a tie
    keeps the lower element first."""
    v1, v2 = k1.reshape(shape), k2.reshape(shape)
    x1, y1 = v1.select(dim, 0), v1.select(dim, 1)
    x2, y2 = v2.select(dim, 0), v2.select(dim, 1)
    le = x1 <= y1
    k1 = torch.stack([torch.where(le, x1, y1), torch.where(le, y1, x1)], dim)
    k2 = torch.stack([torch.where(le, x2, y2), torch.where(le, y2, x2)], dim)
    return k1, k2


def merge_flat(k1: torch.Tensor, k2: torch.Tensor):
    """The JAX script's ``_merge_flat``: every stride from M/2 down to 1 over
    the whole flat bitonic array of int64 keys (below 2^63: their signed
    order is the u64 order) and a 32-bit payload."""
    m = k1.shape[0]
    stride = m // 2
    while stride >= 1:
        k1, k2 = _exchange(k1, k2, (-1, 2, stride), 1)
        stride //= 2
    return k1.reshape(m), k2.reshape(m)


def merge_rowfused(k1: torch.Tensor, k2: torch.Tensor,
                   log_tail: int = ROWFUSED_LOG_TAIL):
    """The JAX script's ``_merge_rowfused``: the same network, the strides
    below 2^log_tail on a [M / 2^log_tail, 2^log_tail] row view."""
    m = k1.shape[0]
    lt = 1 << log_tail
    stride = m // 2
    while stride >= lt:
        k1, k2 = _exchange(k1, k2, (-1, 2, stride), 1)
        stride //= 2
    rows = m // lt
    while stride >= 1:
        k1, k2 = _exchange(k1, k2, (rows, -1, 2, stride), 2)
        stride //= 2
    return k1.reshape(m), k2.reshape(m)


def merge_inputs(n: int, dev: torch.device):
    """(k1, k2, half) as the JAX script draws them: two sorted halves of
    keys in [0, 2^63) from ``np.random.default_rng(0)``, the second
    reversed (a bitonic array, int64), and the row number as payload
    (int32). The halves are sorted on ``dev``."""
    rng = np.random.default_rng(0)
    a, b = (torch.sort(torch.from_numpy(
        rng.integers(0, 2 ** 63, n // 2, np.uint64).view(np.int64)).to(dev)
    ).values for _ in range(2))
    return torch.cat([a, torch.flip(b, [0])]), _arange32(n, dev), n // 2


def d4_merge_variants(n: int, dev: torch.device, card: str) -> dict:
    k1, k2, half = merge_inputs(n, dev)
    f1, f2 = merge_flat(k1, k2)
    r1, r2 = merge_rowfused(k1, k2)
    ab = torch.cat([k1[:half], torch.flip(k1[half:], [0])])  # a, b ascending
    m1, _ = cuda_merge.merge(ab, k2, (0, half, n))
    ok = (bool(torch.equal(f1, r1)) and bool(torch.equal(f2, r2))
          and bool((r1[1:] >= r1[:-1]).all()) and bool(torch.equal(m1, r1))
          and bool(torch.equal(k1[r2.to(torch.int64)], r1)))
    del f1, f2, r1, r2, m1
    t1 = timeit(lambda: merge_flat(k1, k2), dev, iters=2)
    t2 = timeit(lambda: merge_rowfused(k1, k2), dev, iters=2)
    t3 = timeit(lambda: cuda_merge.merge(ab, k2, (0, half, n)), dev)
    _report(f"D4 merge 2^{n.bit_length() - 1} (u64,u32): flat "
            f"{t1 * 1e3:.3f} ms ({t1 / n * 1e9:.3f} ns/elem) | row-fused "
            f"{t2 * 1e3:.3f} ms ({t2 / n * 1e9:.3f} ns/elem) | B3 on the "
            f"two sorted halves {t3 * 1e3:.4f} ms ok={ok}", ok, card)
    return {"ok": ok, "n": n, "flat_ms": t1 * 1e3, "rowfused_ms": t2 * 1e3,
            "b3_ms": t3 * 1e3}


def run(log_n: int = 24, device="cuda") -> dict:
    """Every probe in turn at n = 2^log_n on ``device``, in the JAX script's
    order; the results by probe. Raises at the first probe that fails."""
    if not 16 <= log_n <= 30:
        raise ValueError("log_n must be in 16..30")
    dev = resolve_device(device)
    n = 1 << log_n
    card = card_line(dev)
    print(f"device ready: {card}", flush=True)
    copies: List[dict] = [d1_pipelined_copy(n, r, dyn, dev, card)
                          for r, dyn in COPY_PROBES]
    return {
        "D1": [c for c in copies if c["dynamic"]],
        "D2": [c for c in copies if not c["dynamic"]],
        "D3": [d3_lane_gather(m, dev, card)
               for m in (1 << GATHER_REF_LOG_N, n)],
        "D4": [d4_merge_variants(m, dev, card) for m in (n, n >> 2)],
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_n", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.log_n, args.device)


if __name__ == "__main__":
    main()
