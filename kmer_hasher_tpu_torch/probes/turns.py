"""P1, P10 and P6 against the one PyTorch call that computes the same
function, in turns on one card: where each call's time goes.

    python -m kmer_hasher_tpu_torch.probes.turns              # on the card

For every shape, the kernel's wrapper and the library call run in turns
(kernel, call, call, kernel, ...; :func:`._common.in_turns`), each timed
three ways: milliseconds per call between CUDA events around a run of calls
(what the probe entry points print), device milliseconds per call (the
durations of what the calls ran on the card, from ``torch.profiler``), and
host microseconds per call (the host's clock around the run, no
synchronisation). Where the events figure follows the host figure and not
the device figure, the call is bound by its host work.

Shapes: P10 at one row (a block's slab of the table and the launch, nearly
no data), at the TPU probe's 2^20 indices and at 2^26; P1 over P10's 2^20
indices, over 2^24 and over 2^26 elements; P6 at the TPU probe's 4,096
records of 2 KB in 2^24 elements and at 131,072 records in 2^26. The
library calls are ``torch.gather(tab, 0, idx64)`` (P10), ``out.copy_(x)``
into a tensor that exists (P1) and ``x.view(-1, 512)[index]`` (P6), each
with its index made beforehand. Needs a CUDA card; prints two lines per
shape with the card's name and power limit, then the rows as one JSON line.
"""
from __future__ import annotations

import json
from typing import List

import torch

from . import cuda_probes as cp
from . import cuda_probes_dma as cpd
from . import cuda_probes_r3 as cp3
from . import sort_probes_r3 as sp3
from ._common import card_line, in_turns

LOG_N = 26
REF_LOG_N = 24  # P1's smaller shape; the elements that hold P6's 4,096
GATHER_LOG_N = 20  # the TPU probe's index count of P10
PAIRS, DEVICE_PAIRS = 5, 3  # turns of each function by events, by device


def _rand32(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                         device="cuda", dtype=torch.int32)


def cases(gen: torch.Generator):
    """(kernel, shape, args, library call, calls a timing) for every timed
    shape: 200 calls where one moves a few MB, 20 at 2^24 and above."""
    n = 1 << LOG_N
    x = _rand32(gen, (n,))
    tab = _rand32(gen, (cpd.TABLE_ROWS, cp3.COLS))
    out = []
    for shape, rows in (("one row", 1),
                        (f"2^{GATHER_LOG_N}", (1 << GATHER_LOG_N) // cp3.COLS),
                        (f"2^{LOG_N}", n // cp3.COLS)):
        idx = torch.randint(0, cpd.TABLE_ROWS, (rows, cp3.COLS),
                            generator=gen, device="cuda", dtype=torch.int32)
        idx64 = idx.long()
        out.append(("P10", shape, (tab, idx),
                    lambda tab=tab, idx64=idx64: torch.gather(tab, 0, idx64),
                    20 if rows * cp3.COLS > 1 << 22 else 200))
    small = out[1][2][1].reshape(-1)  # P10's 2^20 indices
    for shape, v in ((f"2^{GATHER_LOG_N}, P10's indices", small),
                     (f"2^{REF_LOG_N}", x[: 1 << REF_LOG_N]), (f"2^{LOG_N}", x)):
        dst = torch.empty_like(v)
        out.append(("P1", shape, (v,), lambda dst=dst, v=v: dst.copy_(v),
                    20 if v.numel() > 1 << 22 else 200))
    for v, ref in ((x[: 1 << REF_LOG_N], True), (x, False)):
        x2 = v.reshape(-1, cp3.COLS)
        recs = v.reshape(-1, cp3.SMALL_ROWS * cp3.COLS)
        offs = (sp3.reference_row_offsets(x2.shape[0], cp3.SMALL_ROWS,
                                          sp3.REF_RECORDS) if ref else
                sp3.spread_row_offsets(x2.shape[0], cp3.SMALL_ROWS))
        shape = f"{len(offs):,} records"
        o = torch.from_numpy(offs).cuda()
        if bool((o % cp3.SMALL_ROWS).any()):  # not all on a record: rows
            rows = (o.long()[:, None] + torch.arange(
                cp3.SMALL_ROWS, device="cuda")).reshape(-1)
            lib = (lambda rows=rows, x2=x2: x2[rows])
        else:
            rec = o.long() // cp3.SMALL_ROWS
            lib = (lambda rec=rec, recs=recs: recs[rec])
        out.append(("P6", shape, (x2, o), lib,
                    20 if o.numel() > 1 << 14 else 200))
    return out


KERNELS = {"P1": (cp.copy, "out.copy_(x)"),
           "P6": (cp3.small_copy, "x.view(-1, 512)[index]"),
           "P10": (cpd.lane_gather, "torch.gather(tab, 0, idx64)")}


def run(seed: int = 20261017) -> List[dict]:
    """Every shape in turns; two printed lines and one row each."""
    if not torch.cuda.is_available():
        raise RuntimeError("the turns need a CUDA card")
    card = card_line(torch.device("cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = []
    for name, shape, args, lib, iters in cases(gen):
        fn, lib_name = KERNELS[name]
        fns = {"kernel": lambda fn=fn, args=args: fn(*args), "library": lib}
        want = fns["kernel"]()
        if not torch.equal(lib().reshape(want.shape), want):
            raise AssertionError(f"{name}, {shape}: the library call "
                                 f"disagrees with the kernel")
        del want
        got = in_turns(fns, iters=iters, pairs=PAIRS,
                       device_pairs=DEVICE_PAIRS)
        rows.append({"probe": name, "shape": shape, "library_call": lib_name,
                     "card": card, **got})
        parts = []
        for who, label in (("kernel", "kernel"), ("library", lib_name)):
            t = got[who]
            dev = ("not measured" if t["device_ms"] is None
                   else f"{t['device_ms']:.4f} ms")
            parts.append(f"{label}: events {t['ms']:.4f} ms, device {dev}, "
                         f"host {t['host_us_per_call']:.1f} us/call")
        print(f"[turns] {name}, {shape} (medians of {2 * PAIRS} / "
              f"{2 * DEVICE_PAIRS} turns): " + "; ".join(parts)
              + f" | {card}", flush=True)
        print(f"[turns] {name}, {shape}: on the device per call, last "
              f"device turn: " + "; ".join(
                  f"{who}: " + ", ".join(
                      f"{n:g} x {a} {ms:.4f} ms"
                      for a, (n, ms) in got[who]["activities"].items())
                  for who in fns), flush=True)
    return rows


def main() -> None:
    rows = run()
    print(json.dumps({"turns": rows}), flush=True)


if __name__ == "__main__":
    main()
