"""Device-side end-to-end counting benchmark (the port's twin of
``tools/chip_probes/e2e_device_bench.py``).

    python -m kmer_hasher_tpu_torch.probes.e2e_device_bench [--device cpu]

Stages synthetic read batches on the device, then drives the production
counting path over them with one final synchronisation, so that the
device's rate shows apart from the file reader and the upload. Stages, each
timed cold and warm on the host's clock around work that ends in a
synchronisation:

  FSM    B2 alone, the f32 instantiation with flags, over every batch;
  FUSED  ``counting._fused_rp_batch`` alone (filter, canonical, run build);
  STORE  ``CountStore.add_run`` over runs built beforehand, with its tier
         merges (no fold);
  E2E    ``counting.count_batches``, the loop of the file entry: fused
         batch, store, hybrid sweep, final fold.

Environment: ``E2E_BATCHES`` (64), ``E2E_K`` (21), ``E2E_READLEN`` (151),
``E2E_ROWS`` (the largest multiple of 1,024 with rows x windows <= 2^22:
29,696 at 151 bases and k=21), ``E2E_MODE`` (hybrid | fast | exact),
``E2E_QUALS`` (stress | binned | uniform).

Quality models: ``stress`` phred 30-40 with about 2% of the bases at phred
2-19 (``examples/counting_stress.py``'s reads), ``binned`` the NovaSeq RTA3
alphabet F : , # (phred 37/25/11/2) at 0.88 / 0.08 / 0.02 / 0.02,
``uniform`` phred 2-40. Under ``uniform`` next to no window passes
``min_q`` 20, so its E2E times the filter, not the store.

Batches are [rows, L] with L the read length rounded up to a multiple of 8,
the padding of the port's readers (the JAX tool pads to its TPU shape
bucket); the JSON line gives the bytes a read takes on the device.
Prints the card line, one line a stage, and ``E2E_DEVICE {json}``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch

from .. import counting
from ..index.count_store import CountStore
from ..index.position_index import resolve_device
from ..ops import cuda_scan
from ..qll import Q_TO_LL
from ._common import card_line, sync

MODES = ("hybrid", "fast", "exact")
QUALS = ("stress", "binned", "uniform")
EXACT_LL = {"hybrid": "hybrid", "fast": False, "exact": True}
COL_MULTIPLE = 8  # the column padding of the port's readers
NOVASEQ_BINS, NOVASEQ_P = b"F:,#", (0.88, 0.08, 0.02, 0.02)

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def default_rows(read_len: int, k: int) -> int:
    """The largest multiple of 1,024 rows whose windows fit 2^22."""
    return (1 << 22) // counting.win_bucket(read_len, k) // 1024 * 1024


def padded_width(read_len: int) -> int:
    return -(-read_len // COL_MULTIPLE) * COL_MULTIPLE


def draw_quals(gen: torch.Generator, shape, quals: str,
               dev: torch.device) -> torch.Tensor:
    """uint8 phred+33 qualities of one quality model, drawn on ``dev``."""
    if quals == "stress":
        q = torch.randint(63, 74, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
        low = torch.rand(shape, generator=gen, device=dev) < 0.02
        lowq = torch.randint(35, 53, shape, generator=gen, device=dev,
                             dtype=torch.uint8)
        return torch.where(low, lowq, q)
    if quals == "binned":
        u = torch.rand(shape, generator=gen, device=dev)
        pick = torch.zeros(shape, dtype=torch.int64, device=dev)
        edge = 0.0
        for p in NOVASEQ_P[:-1]:
            edge += p
            pick += (u >= edge).long()
        bins = torch.tensor(list(NOVASEQ_BINS), dtype=torch.uint8,
                            device=dev)
        return bins[pick]
    if quals == "uniform":
        return torch.randint(33 + 2, 33 + 41, shape, generator=gen,
                             device=dev, dtype=torch.uint8)
    raise ValueError(f"unknown quality model {quals!r}")


def draw_batch(gen: torch.Generator, rows: int, read_len: int, quals: str,
               dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seq, qual) [rows, padded_width(read_len)] on ``dev``: uniform
    bases, N past ``read_len``, qualities of model ``quals``."""
    L = padded_width(read_len)
    nuc = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    seq = nuc[torch.randint(0, 4, (rows, L), generator=gen, device=dev)]
    seq[:, read_len:] = ord("N")
    return seq, draw_quals(gen, (rows, L), quals, dev)


def make_batches(n_batches: int, rows: int, read_len: int, seed: int = 0,
                 quals: str = "stress", device="cuda") -> List[Batch]:
    """``n_batches`` (seq, qual, lengths, has_qual) batches drawn on the
    device, batch i from a generator seeded ``seed * 1000 + i``."""
    dev = resolve_device(device)
    lengths = torch.full((rows,), read_len, dtype=torch.int32, device=dev)
    has_qual = torch.ones(rows, dtype=torch.bool, device=dev)
    out = []
    for i in range(n_batches):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1000 + i)
        out.append(draw_batch(gen, rows, read_len, quals, dev)
                   + (lengths, has_qual))
    sync(dev)
    return out


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")


def _fused(batch: Batch, k: int, mode: str, min_q: int, read_len: int):
    return counting._fused_rp_batch(
        *batch, k, 1, 0, float(Q_TO_LL[33 + min_q]), mode,
        min_q_char=33 + min_q, n_win=counting.win_bucket(read_len, k))


def run_fsm_only(batches: Sequence[Batch], k: int, min_q: int = 20) -> None:
    """B2, f32 with flags, over every batch."""
    min_ll = float(Q_TO_LL[33 + min_q])
    for seq, qual, lengths, _hq in batches:
        cuda_scan.scan(seq, qual, lengths, k, min_ll, precision="fast",
                       return_flags=True, min_q_char=33 + min_q)
    sync(batches[0][0].device)


def run_fused_only(batches: Sequence[Batch], k: int, mode: str,
                   min_q: int = 20, read_len: int = 151) -> None:
    """``_fused_rp_batch`` over every batch; the runs are dropped."""
    _check_mode(mode)
    for b in batches:
        _fused(b, k, mode, min_q, read_len)
    sync(batches[0][0].device)


def build_runs(batches: Sequence[Batch], k: int, mode: str,
               min_q: int = 20, read_len: int = 151) -> list:
    """Every batch's run (keys, cnt, n_obs), kept for STORE. In hybrid
    mode a flagged read is left out, as the loop leaves it out before its
    sweep."""
    _check_mode(mode)
    runs = [_fused(b, k, mode, min_q, read_len)[:3] for b in batches]
    sync(batches[0][0].device)
    return runs


def run_store_only(runs: list, k: int) -> CountStore:
    """``add_run`` of every prebuilt run into a new store, with its tier
    merges; no fold."""
    store = CountStore(k, counts_n=1, mode="sh", device=runs[0][0].device)
    for keys, cnt, n_obs in runs:
        store.add_run(keys, cnt, n_obs)
    sync(store.device)
    return store


def run_e2e(batches: Sequence[Batch], k: int, mode: str, min_q: int = 20,
            stats: Optional[dict] = None) -> CountStore:
    """``count_batches`` over the staged batches into a new store: the
    production loop, hybrid sweep and final fold included."""
    _check_mode(mode)
    store = CountStore(k, counts_n=1, mode="sh", device=batches[0][0].device)
    counting.count_batches(store, batches, k, min_q=min_q,
                           exact_ll=EXACT_LL[mode], stats=stats)
    sync(store.device)
    return store


def run(n_batches: int = 64, k: int = 21, read_len: int = 151,
        rows: Optional[int] = None, mode: str = "hybrid",
        quals: str = "stress", min_q: int = 20, device="cuda") -> dict:
    """Every stage, cold then warm, over ``n_batches`` staged batches;
    prints the lines and returns the JSON line's record."""
    _check_mode(mode)
    dev = resolve_device(device)
    rows = default_rows(read_len, k) if rows is None else int(rows)
    n_reads = n_batches * rows
    card = card_line(dev)
    print(card, flush=True)
    print(f"e2e device bench: {n_batches} x {rows} rows, k={k}, mode={mode}, "
          f"quals={quals}, {n_reads} reads", flush=True)
    t0 = time.perf_counter()
    batches = make_batches(n_batches, rows, read_len, quals=quals,
                           device=dev)
    print(f"staged {n_reads} reads on {dev.type} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    runs = build_runs(batches, k, mode, min_q, read_len)
    stats: dict = {}
    stages = {}
    out = None
    for name, fn in (
            ("FSM", lambda: run_fsm_only(batches, k, min_q)),
            ("FUSED", lambda: run_fused_only(batches, k, mode, min_q,
                                             read_len)),
            ("STORE", lambda: run_store_only(runs, k)),
            ("E2E", lambda: run_e2e(batches, k, mode, min_q, stats))):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        cold = time.perf_counter() - t0
        stats.clear()
        t0 = time.perf_counter()
        out = fn()
        warm = time.perf_counter() - t0
        stages[name] = {"cold_s": cold, "warm_s": warm,
                        "reads_per_s": n_reads / warm,
                        "ms_per_batch": warm / n_batches * 1e3}
        print(f"{name}: warm {warm:.3f}s = {n_reads / warm:,.0f} reads/s "
              f"({warm / n_batches * 1e3:.2f} ms/batch; cold {cold:.3f}s)",
              flush=True)
    tm = out.timings
    distinct, total = out.n_unique, int(out.total_added.sum())
    print(f"  distinct={distinct:,} total={total:,}; "
          f"{stats.get('flagged_reads', 0):,} reads flagged and re-counted "
          f"in f64; tier merges {tm['tier_merges']} in "
          f"{tm['tier_merge_s']:.3f}s, final fold {tm['fold_s']:.3f}s",
          flush=True)
    rec = {"batches": n_batches, "rows": rows, "reads": n_reads, "k": k,
           "read_len": read_len, "mode": mode, "quals": quals,
           "min_q": min_q,
           "bytes_per_read": 2 * padded_width(read_len) + 4 + 1,
           "stages": stages, "distinct": distinct, "total": total,
           "flagged_reads": stats.get("flagged_reads", 0),
           "tier_merges": tm["tier_merges"],
           "tier_merge_s": tm["tier_merge_s"], "fold_s": tm["fold_s"],
           "device": dev.type, "card": card}
    print("E2E_DEVICE " + json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    k = int(os.environ.get("E2E_K", "21"))
    read_len = int(os.environ.get("E2E_READLEN", "151"))
    rows = os.environ.get("E2E_ROWS")
    return run(int(os.environ.get("E2E_BATCHES", "64")), k, read_len,
               None if rows is None else int(rows),
               os.environ.get("E2E_MODE", "hybrid"),
               os.environ.get("E2E_QUALS", "stress"), device=args.device)


if __name__ == "__main__":
    main()
