"""The full-corpus spill regime (the port's twin of
``tools/chip_probes/spill_regime.py``).

    python -m kmer_hasher_tpu_torch.probes.spill_regime [--device cpu]

The reference's flagship corpus is 4.3e8 reads and 7.73e8 distinct k-mers
(its test.R:491-505): a count table past what a device holds beside its
workspace. This drives the production per-batch path,
``counting._fused_rp_batch`` (f32 filter) into ``CountStore.add_run`` with
its tier merges, at about 5e8 distinct keys with ``spill_bytes`` well under
the device's memory, so that

* runs spill to host memory during the loop,
* the fold goes by key range (``CountStore._fold_spilled_ranged``), since
  one rejoin's merge workspace would not fit the fold budget, and
* the result is held against a sliced exact control: a second store fed
  only the keys whose raw pattern is below 2^32 (the top 10 of k=21's 42
  bits zero: 1/1024 of the key space, a sorted prefix of every run) must
  equal the big table's prefix bitwise.

Reads are 151 bases with stress qualities (``e2e_device_bench``), batch i
drawn on the device from a generator seeded 1000 + i.

Environment: ``SPILL_BATCHES`` (244), ``SPILL_K`` (21), ``SPILL_BYTES``
(``3 << 29``), ``SPILL_ROWS`` (the largest multiple of 1,024 with rows x
windows <= 2^22), ``KMH_FOLD_BUDGET_BYTES`` (3 GiB here, passed to both
stores as ``fold_budget_bytes``). Prints the card line, a line a spill,
the loop, fold, spectrum and control lines, and ``SPILL_REGIME {json}``;
raises where the control differs, where fewer than 2 runs spilled, or
where a run of at least 5e8 windows gives fewer than 5e8 distinct k-mers.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import counting
from ..index.count_store import CountStore
from ..index.position_index import resolve_device
from ..ops.encode import SIGN
from ..qll import Q_TO_LL
from . import e2e_device_bench as e2e
from ._common import card_line, sync

READ_LEN = 151
FOLD_BUDGET = 3 << 30
SLICE_TOP = 1 << 32  # raw k-mers below it make the control's slice
FULL_SCALE = 5e8  # windows from which the regime must give 5e8 distinct


def control_slice(keys: torch.Tensor, cnt: torch.Tensor):
    """The rows of a sorted run whose raw pattern is below SLICE_TOP (its
    sorted prefix): (keys, cnt, observations)."""
    sl = (keys ^ SIGN) < SLICE_TOP
    keys, cnt = keys[sl], cnt[sl]
    return keys, cnt, int(cnt.sum())


def control_prefix_equal(store: CountStore, control: CountStore) -> tuple:
    """(rows of the folded big table below SLICE_TOP, whether they equal
    the folded control store's table bitwise and are not empty)."""
    n0 = int(((store.keys ^ SIGN) < SLICE_TOP).sum())
    ok = (n0 == control.n_unique > 0
          and torch.equal(store.keys[:n0], control.keys)
          and torch.equal(store.cnt[:n0], control.cnt)
          and int(control.total_added.sum()) == int(control.cnt.sum()))
    return n0, ok


def run(n_batches: int = 244, k: int = 21, spill_bytes: int = 3 << 29,
        rows: Optional[int] = None, fold_budget: int = FOLD_BUDGET,
        min_q: int = 20, device="cuda") -> dict:
    """The regime; prints its lines and returns the JSON line's record with,
    besides, the folded ``store`` and ``control`` and the store's timings
    at the end of the loop (``loop_timings``)."""
    dev = resolve_device(device)
    nw = counting.win_bucket(READ_LEN, k)
    rows = e2e.default_rows(READ_LEN, k) if rows is None else int(rows)
    n_reads = n_batches * rows
    min_ll_f = float(Q_TO_LL[33 + min_q])
    card = card_line(dev)
    print(card, flush=True)
    print(f"spill regime: {n_batches} x {rows} rows x {READ_LEN} bp, k={k}, "
          f"spill_bytes={spill_bytes >> 20} MiB, fold_budget="
          f"{fold_budget >> 20} MiB, {n_reads:,} reads, "
          f"~{n_reads * nw / 1e8:.1f}e8 windows", flush=True)
    lengths = torch.full((rows,), READ_LEN, dtype=torch.int32, device=dev)
    has_qual = torch.ones(rows, dtype=torch.bool, device=dev)
    sync(dev)
    t_all = time.perf_counter()
    store = CountStore(k, counts_n=1, mode="sh", spill_bytes=spill_bytes,
                       fold_budget_bytes=fold_budget, device=dev)
    control = CountStore(k, counts_n=1, mode="sh",
                         fold_budget_bytes=fold_budget, device=dev)
    for i in range(n_batches):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + i)
        seq, qual = e2e.draw_batch(gen, rows, READ_LEN, "stress", dev)
        keys, cnt, n_obs = counting._fused_rp_batch(
            seq, qual, lengths, has_qual, k, 1, 0, min_ll_f, "fast",
            min_q_char=33 + min_q, n_win=nw)[:3]
        control.add_run(*control_slice(keys, cnt))
        spills = store.timings["spills"]
        t0 = time.perf_counter()
        store.add_run(keys, cnt, n_obs)
        if store.timings["spills"] > spills:
            print(f"  batch {i + 1}/{n_batches}: spill "
                  f"#{store.timings['spills']} "
                  f"({time.perf_counter() - t0:.3f}s incl. readback); "
                  f"host-spilled rows so far: "
                  f"{store.timings['spilled_rows']:,}", flush=True)
    sync(dev)
    t_loop = time.perf_counter() - t_all
    loop_tm = dict(store.timings)
    print(f"count loop: {t_loop:.3f}s ({n_reads / t_loop:,.0f} reads/s "
          f"incl. {loop_tm['spill_s']:.3f}s spill readback), "
          f"{loop_tm['spills']} spills", flush=True)
    t0 = time.perf_counter()
    store.flush()
    sync(dev)
    t_fold = time.perf_counter() - t0
    tm = store.timings
    distinct, total = store.n_unique, int(store.total_added.sum())
    print(f"fold (ranged rejoin: {tm['ranged_folds']} ranged folds, "
          f"{tm['ranges']} ranges, {tm['range_rounds']} B3 rounds): "
          f"{t_fold:.3f}s -> distinct={distinct:,} "
          f"total={total:,}", flush=True)
    t0 = time.perf_counter()
    spec = store.spectrum(10)
    t_spec = time.perf_counter() - t0
    print(f"spectrum(10) over {distinct:,} keys: {t_spec:.3f}s; "
          f"head={spec[:4].astype(np.int64).tolist()}", flush=True)
    control.flush()
    n0, ok = control_prefix_equal(store, control)
    print(f"sliced exact control (raw < 2^32: the top {max(0, 2 * k - 32)} "
          f"of {2 * k} bits zero): big-table prefix rows={n0:,} control "
          f"rows={control.n_unique:,} bitwise-equal={ok}", flush=True)
    wall = time.perf_counter() - t_all
    rec = {"reads": n_reads, "k": k, "distinct": distinct, "total": total,
           "spills": tm["spills"], "loop_spills": loop_tm["spills"],
           "wall_s": wall, "loop_s": t_loop,
           "spill_readback_s": loop_tm["spill_s"], "fold_s": t_fold,
           "ranged_folds": tm["ranged_folds"], "ranges": tm["ranges"],
           "range_rounds": tm["range_rounds"],
           "spectrum_s": t_spec, "reads_per_s": n_reads / wall,
           "control_rows": n0, "control_ok": ok, "device": dev.type,
           "card": card}
    print("SPILL_REGIME " + json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError("sliced exact control mismatch")
    if loop_tm["spills"] < 2:
        raise AssertionError("fewer than 2 spills: not the regime")
    if n_reads * nw >= FULL_SCALE and distinct < FULL_SCALE:
        raise AssertionError(f"{distinct:,} distinct k-mers at full scale")
    return dict(rec, store=store, control=control, spectrum=spec,
                loop_timings=loop_tm)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = os.environ.get("SPILL_ROWS")
    return run(int(os.environ.get("SPILL_BATCHES", "244")),
               int(os.environ.get("SPILL_K", "21")),
               int(os.environ.get("SPILL_BYTES", str(3 << 29))),
               None if rows is None else int(rows),
               int(os.environ.get("KMH_FOLD_BUDGET_BYTES", str(FOLD_BUDGET))),
               device=args.device)


if __name__ == "__main__":
    main()
