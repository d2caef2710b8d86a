"""Headline benchmark of the port: k-mers indexed per second at k=32 (the
twin of the JAX package's ``bench.py``).

    python -m kmer_hasher_tpu_torch.bench [--device cpu]

Builds the position index's sorted arrays (``build_index_arrays``: B1's
encode -> sort -> segment grouping) over a random sequence held on the
device, CHAIN builds in a row, each after mutating one base so that every
build is real work, and reports the steady-state rate: the best of ITERS
chains, each ended by a synchronisation, over CHAIN.

Environment: ``BENCH_K`` (32), ``BENCH_LOG_L`` (25; capped at 20 on the
CPU), ``BENCH_CHAIN`` (8), ``BENCH_ITERS`` (3).

Reference baseline: about 4e6 k-mers/s inserted on one core (a 32-mer index
of a 40 Mbp sequence in about 10 s, the reference's README.md:136-139).

Prints the card's name and power limit on standard error and ONE JSON line
on standard output, ``{"metric", "value", "unit", "vs_baseline"}``; run as
a module, an error prints the ``bench_error`` record instead and exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import torch

from .index.position_index import build_index_arrays, resolve_device
from .probes._common import best_time, card_line

BASELINE_KMERS_PER_S = 4.0e6  # reference single-core insert rate
CPU_MAX_LOG_L = 20  # keeps a run without a card small


def make_sequence(L: int, dev: torch.device, seed: int = 0) -> torch.Tensor:
    """L random bases (uint8 ASCII of ACGT) drawn on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nuc = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    return nuc[torch.randint(0, 4, (L,), generator=gen, device=dev)]


def chain(seq: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """``n`` builds of a copy of ``seq``, base i set to ACGT[i % 4] before
    build i; the sum of every build's n_valid and first sorted key, on the
    device (no synchronisation here)."""
    nuc = b"ACGT"
    s = seq.clone()
    acc = torch.zeros((), dtype=torch.int64, device=seq.device)
    for i in range(n):
        s[i] = nuc[i % 4]
        s_key, _pos, n_valid, _st, _sg = build_index_arrays(
            s, k, s.shape[0])
        acc = acc + n_valid + s_key[0]
    return acc


def run(k: int = 32, log_l: int = 25, n_chain: int = 8, iters: int = 3,
        device="cuda") -> dict:
    """The benchmark's record on ``device``: the JSON line's fields, with
    the best chain's seconds and the accumulator for checks."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        log_l = min(log_l, CPU_MAX_LOG_L)
    L = 1 << log_l
    seq = make_sequence(L, dev)
    best, acc = best_time(lambda: int(chain(seq, k, n_chain)), dev, iters)
    rate = L / (best / n_chain)
    return {"metric": f"kmers indexed/s/chip (k={k}, L=2^{log_l}, "
                      f"{dev.type})",
            "value": round(rate, 1), "unit": "kmers/s",
            "vs_baseline": round(rate / BASELINE_KMERS_PER_S, 3),
            "chain_s": best, "acc": acc}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), file=sys.stderr, flush=True)
    rec = run(int(os.environ.get("BENCH_K", "32")),
              int(os.environ.get("BENCH_LOG_L", "25")),
              int(os.environ.get("BENCH_CHAIN", "8")),
              int(os.environ.get("BENCH_ITERS", "3")), dev)
    print(json.dumps({key: rec[key] for key in
                      ("metric", "value", "unit", "vs_baseline")}),
          flush=True)
    return rec


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # a parseable failure record, as bench.py's
        print(json.dumps({"metric": "bench_error", "value": 0,
                          "unit": str(e), "vs_baseline": 0}))
        sys.exit(1)
