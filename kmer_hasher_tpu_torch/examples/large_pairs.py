"""BASELINE config 4: a k=32 index of a ~40 Mbp chromosome whose dot-plot
pair table is streamed in chunks (the port's twin of the JAX package's
``examples/large_pairs.py``) — the regime where the reference dies: more
than 9e9 pairs from a 40 Mbp index exhaust R's allocator (its README.md
:80-89).

    python -m kmer_hasher_tpu_torch.examples.large_pairs [--mbp 40]
        [--copies 300] [--max-stream-pairs 200000000] [--drain-on-device]
        [--device cpu]

Builds a synthetic chromosome with numpy from ``default_rng(0)``, the JAX
script's own draws (a random background and, in its middle, a 5,000-base
unit repeated ``--copies`` times, so that the pair table grows with the
square of the copies), indexes it at k=32 on the device and streams the
(i, x, y) rows through ``KmerIndex.iter_pair_chunks`` in chunks of 2^22,
never holding the whole table, until ``--max-stream-pairs`` rows have come.
Each chunk's column 1 (x) goes into an XOR checksum.

By default every chunk is copied to the host, as a user of the stream gets
it. ``--drain-on-device`` counts the rows and XORs the checksum on the
device instead, one synchronisation at the end: the form for tables of
billions of rows (1,000 copies give about 2.5e9 pairs, past 2^31).

Prints the card line, the JAX script's lines and ``LARGE_PAIRS {json}``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ..index.position_index import KmerIndex, resolve_device
from ..probes._common import card_line, sync

K = 32
CHUNK = 1 << 22
UNIT = 5_000


def make_sequence(mbp: float, copies: int) -> np.ndarray:
    """int(mbp * 1e6) uint8 bases: background halves around ``copies``
    tandem copies of a UNIT-base unit, drawn as the JAX script draws them."""
    L = int(mbp * 1e6)
    rng = np.random.default_rng(0)
    nuc = np.frombuffer(b"ACGT", np.uint8)
    unit = nuc[rng.integers(0, 4, UNIT)]
    repeat_region = np.tile(unit, copies)
    if repeat_region.shape[0] > L:
        raise ValueError(f"{copies} copies of {UNIT} bases do not fit "
                         f"{L:,} bases")
    background = nuc[rng.integers(0, 4, L - len(repeat_region))]
    return np.concatenate([background[: L // 2], repeat_region,
                           background[L // 2:]])


def xor_all(x: torch.Tensor) -> torch.Tensor:
    """The XOR of every element of a 1-D tensor as an int64 0-dim tensor on
    its device (0 for none), by halving."""
    x = x.to(torch.int64)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros(1)])
        h = x.shape[0] // 2
        x = x[:h] ^ x[h:]
    return x[0] if x.shape[0] else x.new_zeros(())


def stream(idx: KmerIndex, max_pairs: int, on_device: bool):
    """(rows streamed, XOR of column 1) over the pair chunks of ``idx``
    until at least ``max_pairs`` rows have come."""
    streamed = 0
    if on_device:
        acc = torch.zeros((), dtype=torch.int64, device=idx.device)
        for chunk in idx.iter_pair_chunks(capacity=CHUNK):
            streamed += chunk.shape[0]
            acc ^= xor_all(chunk[:, 1])
            if streamed >= max_pairs:
                break
        return streamed, int(acc)
    checksum = np.int64(0)
    for chunk in idx.iter_pair_chunks(capacity=CHUNK):
        rows = chunk.cpu().numpy()
        streamed += len(rows)
        checksum ^= np.bitwise_xor.reduce(rows[:, 1].astype(np.int64))
        if streamed >= max_pairs:
            break
    return streamed, int(checksum)


def run(mbp: float = 40.0, copies: int = 300,
        max_stream_pairs: int = 200_000_000, drain_on_device: bool = False,
        device="cuda") -> dict:
    """The example; prints its lines and returns the JSON line's record
    with, besides, the ``index``."""
    dev = resolve_device(device)
    card = card_line(dev)
    print(card, flush=True)
    seq = make_sequence(mbp, copies)
    print(f"chromosome: {len(seq) / 1e6:.1f} Mbp with a "
          f"{UNIT * copies / 1e6:.1f} Mbp tandem-repeat region "
          f"({copies} copies), device={dev.type}", flush=True)

    sync(dev)
    t0 = time.perf_counter()
    idx = KmerIndex(seq, K, device=dev)
    total = idx.total_pairs
    t_build = time.perf_counter() - t0
    print(f"k={K} index built in {t_build:.3f}s: {idx.n_valid:,} windows, "
          f"{idx.n_kmers:,} distinct, {total:,} dot-plot pairs pending",
          flush=True)
    t0 = time.perf_counter()
    streamed, checksum = stream(idx, max_stream_pairs, drain_on_device)
    sync(dev)
    dt = time.perf_counter() - t0
    frac = streamed / total if total else 1.0
    where = ("counted on the device" if drain_on_device else
             f"peak host memory bounded by one {CHUNK:,}-row chunk")
    print(f"streamed {streamed:,}/{total:,} pairs ({frac:.0%}) in "
          f"{dt:.3f}s ({streamed / max(dt, 1e-9) / 1e6:.1f} Mpairs/s), "
          f"{where} (checksum {checksum})", flush=True)
    print("no OOM: the reference materialises this table and dies "
          "(README.md:80-89); here it streams.", flush=True)
    rec = {"mbp": mbp, "copies": copies, "k": K, "windows": idx.n_valid,
           "distinct": idx.n_kmers, "total_pairs": total,
           "streamed": streamed, "checksum": checksum, "build_s": t_build,
           "stream_s": dt, "mpairs_per_s": streamed / max(dt, 1e-9) / 1e6,
           "drain_on_device": drain_on_device, "chunk": CHUNK,
           "device": dev.type, "card": card}
    print("LARGE_PAIRS " + json.dumps(rec), flush=True)
    return dict(rec, index=idx)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mbp", type=float, default=40.0)
    ap.add_argument("--copies", type=int, default=300,
                    help="tandem copies of the 5 kb repeat unit")
    ap.add_argument("--max-stream-pairs", type=int, default=200_000_000,
                    help="stop streaming after this many rows")
    ap.add_argument("--drain-on-device", action="store_true",
                    help="count rows and XOR the checksum on the device, "
                         "with no copy to the host")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.mbp, args.copies, args.max_stream_pairs,
              args.drain_on_device, args.device)
    rec.pop("index")
    return rec


if __name__ == "__main__":
    main()
