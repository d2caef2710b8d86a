"""Hybrid against fast through the sharded count store (the port's twin of
``tools/chip_probes/sharded_hybrid_bench.py``).

    python -m kmer_hasher_tpu_torch.probes.sharded_hybrid_bench
        [--device cpu]

``ShardedCountStore.add_reads`` on a one-shard group over the same staged
batches of stress-quality reads (``e2e_device_bench``'s model, whose window
sums come near the threshold) in the modes fast, hybrid and exact, each
cold and warm on the host's clock around work that ends in a
synchronisation. In hybrid mode ``add_reads`` re-counts a batch's flagged
reads in f64 before it returns, so the hybrid store must equal the exact
one; the run raises if it does not. Also counts the reads that B2 flags
(f32 with flags): how much re-counting the hybrid figure carries.

Environment: ``SHB_BATCHES`` (16), ``SHB_K`` (21), ``SHB_ROWS`` (the
largest multiple of 1,024 with rows x windows <= 2^22). Reads are 151 bases.
Prints the card line, one line a mode, and ``SHARDED_HYBRID {json}``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..counting import win_bucket
from ..index.position_index import resolve_device
from ..ops import cuda_scan
from ..parallel import ShardedCountStore, make_mesh
from ..qll import Q_TO_LL
from . import e2e_device_bench as e2e
from ._common import card_line, sync

READ_LEN = 151
MODES = ("fast", "hybrid", "exact")


def count_flags(batches, lengths, k: int, min_q: int = 20) -> int:
    """Reads B2 flags (f32 with flags) over every (seq, qual) batch."""
    min_ll = float(Q_TO_LL[33 + min_q])
    return sum(int(cuda_scan.scan(seq, qual, lengths, k, min_ll,
                                  precision="fast", return_flags=True,
                                  min_q_char=33 + min_q)[3].sum())
               for seq, qual in batches)


def run_store(batches, lengths, has_qual, k: int, nw: int, precision: str,
              min_q: int = 20) -> ShardedCountStore:
    """A new one-shard store on the batches' device, every (seq, qual)
    batch through ``add_reads``, then a synchronisation."""
    dev = lengths.device
    store = ShardedCountStore(k, make_mesh(1, device=dev), counts_n=1)
    min_ll_f = float(Q_TO_LL[33 + min_q])
    for seq, qual in batches:
        store.add_reads(seq, qual, lengths, has_qual, min_ll_f,
                        precision=precision, source=0,
                        min_q_char=33 + min_q, n_win=nw)
    sync(dev)
    return store


def same_store(a: ShardedCountStore, b: ShardedCountStore) -> bool:
    """Equal shard tables (keys and counts), totals and spectra."""
    return (all(torch.equal(x.keys, y.keys) and torch.equal(x.cnt, y.cnt)
                for x, y in zip(a.flush().shards, b.flush().shards))
            and int(a.peek_n_unique()) == int(b.peek_n_unique())
            and bool((a.total_added == b.total_added).all())
            and bool((np.asarray(a.spectrum(5))
                      == np.asarray(b.spectrum(5))).all()))


def run(n_batches: int = 16, k: int = 21, rows: Optional[int] = None,
        device="cuda") -> dict:
    """Every mode, cold then warm; prints the lines and returns the JSON
    line's record. Raises where hybrid differs from exact."""
    dev = resolve_device(device)
    nw = win_bucket(READ_LEN, k)
    rows = e2e.default_rows(READ_LEN, k) if rows is None else int(rows)
    n_reads = n_batches * rows
    card = card_line(dev)
    print(card, flush=True)
    print(f"sharded hybrid bench: {n_batches} x {rows} x {READ_LEN} bp, "
          f"k={k}, {n_reads:,} reads", flush=True)
    staged = e2e.make_batches(n_batches, rows, READ_LEN, quals="stress",
                              device=dev)
    batches = [b[:2] for b in staged]
    lengths, has_qual = staged[0][2], staged[0][3]
    n_flags = count_flags(batches, lengths, k)
    print(f"genuine borderline flags: {n_flags} / {n_reads} reads",
          flush=True)
    walls, stores = {}, {}
    for mode in MODES:
        t0 = time.perf_counter()
        run_store(batches, lengths, has_qual, k, nw, mode)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        stores[mode] = run_store(batches, lengths, has_qual, k, nw, mode)
        walls[mode] = time.perf_counter() - t0
        print(f"{mode}: warm {walls[mode]:.3f}s = "
              f"{n_reads / walls[mode]:,.0f} reads/s (cold {cold:.3f}s)",
              flush=True)
    eq = same_store(stores["hybrid"], stores["exact"])
    rec = {"reads": n_reads, "k": k, "flags": n_flags,
           "fast_rps": round(n_reads / walls["fast"]),
           "hybrid_rps": round(n_reads / walls["hybrid"]),
           "exact_rps": round(n_reads / walls["exact"]),
           "hybrid_over_fast": round(walls["hybrid"] / walls["fast"], 3),
           "hybrid_eq_exact": eq,
           "distinct": int(stores["exact"].peek_n_unique()),
           "device": dev.type, "card": card}
    print("SHARDED_HYBRID " + json.dumps(rec), flush=True)
    if not eq:
        raise AssertionError("hybrid != exact")
    return rec


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = os.environ.get("SHB_ROWS")
    return run(int(os.environ.get("SHB_BATCHES", "16")),
               int(os.environ.get("SHB_K", "21")),
               None if rows is None else int(rows), args.device)


if __name__ == "__main__":
    main()
