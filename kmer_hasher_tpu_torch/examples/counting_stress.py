"""End-to-end counting stress: synthetic reads through the whole file path
(parse -> pad -> upload -> likelihood filter -> canonical -> LSM count
store), the port's twin of the JAX package's ``examples/counting_stress.py``.

    python -m kmer_hasher_tpu_torch.examples.counting_stress [--reads 200000]
        [--k 21] [--read-len 151] [--min-q 20] [--exact-ll | --ll-mode MODE]
        [--keep FILE] [--binned-quals] [--sources N] [--report-every N]
        [--device cpu]

The reference sustains about 300k reads/s on 33 Xeon cores into a large
store (its test.R:823-838). The reads are written with numpy from a seed,
exactly as the JAX script writes them, to ``--keep`` (reused where it
exists) or to a temporary file that is removed afterwards, then counted by
``count_kmers_fq_sh_rp``. ``--binned-quals`` writes the NovaSeq RTA3
4-value quality alphabet; the JAX package uploaded such qualities packed
4 bits a base, a form the port measured slower and does not have, so here
they take the same padded byte planes as any other.

Prints the card line, the JAX script's lines and ``COUNTING_STRESS
{json}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from .. import counting
from ..index.position_index import resolve_device
from ..probes._common import card_line, sync


def make_reads(path: str, n: int, read_len: int, seed: int = 0,
               binned: bool = False) -> None:
    """Write n synthetic FASTQ reads of uniform bases: qualities phred 30-40
    with about 2% at phred 2-19, so that the filter rejects some windows but
    not all, or with ``binned`` the RTA3 alphabet F : , # at 0.88 / 0.08 /
    0.02 / 0.02. The same bytes as the JAX script's ``make_reads``."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    if binned:
        bins = np.frombuffer(b"F:,#", np.uint8)  # phred 37/25/11/2
        pick = rng.choice(4, size=(n, read_len), p=[0.88, 0.08, 0.02, 0.02])
        quals = bins[pick]
        seqs = bases[rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)]
    else:
        quals = rng.integers(63, 74, size=(n, read_len), dtype=np.uint8)
        low = rng.random((n, read_len)) < 0.02
        quals[low] = rng.integers(35, 53, size=int(low.sum()),
                                  dtype=np.uint8)
        seqs = bases[rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)]
    nl = np.full((n, 1), ord("\n"), np.uint8)
    hdr = np.tile(np.frombuffer(b"@r\n", np.uint8), (n, 1))
    plus = np.tile(np.frombuffer(b"+\n", np.uint8), (n, 1))
    np.concatenate([hdr, seqs, nl, plus, quals, nl], axis=1).tofile(path)


def exact_ll_of(exact_ll: bool, ll_mode: Optional[str]):
    """``count_kmers_fq_sh_rp``'s ``exact_ll`` from the two flags
    (``--ll-mode`` wins)."""
    if ll_mode is None:
        return exact_ll
    return {"fast": False, "exact": True, "hybrid": "hybrid"}[ll_mode]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--read-len", type=int, default=151)
    ap.add_argument("--min-q", type=int, default=20)
    ap.add_argument("--exact-ll", action="store_true")
    ap.add_argument("--ll-mode", choices=["fast", "exact", "hybrid"],
                    default=None,
                    help="overrides --exact-ll; hybrid = bitwise-exact "
                         "results at about fast speed")
    ap.add_argument("--keep", default=None,
                    help="reuse/keep the synthetic fastq at this path")
    ap.add_argument("--binned-quals", action="store_true",
                    help="NovaSeq-style 4-value quality alphabet")
    ap.add_argument("--sources", type=int, default=1,
                    help="count the file this many times into sources "
                         "0..n-1 of ONE store")
    ap.add_argument("--report-every", type=int, default=50_000,
                    help="progress-meter interval in reads; each report "
                         "counts the store's distinct keys, real work at "
                         "large store sizes — 0 disables")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    print(card, flush=True)
    with contextlib.ExitStack() as cleanup:
        path = args.keep
        if path is None:
            path = os.path.join(
                cleanup.enter_context(tempfile.TemporaryDirectory()),
                f"stress_{args.reads}{'b' if args.binned_quals else ''}.fq")
        if not os.path.exists(path):
            t0 = time.perf_counter()
            make_reads(path, args.reads, args.read_len,
                       binned=args.binned_quals)
            print(f"generated {args.reads} reads in "
                  f"{time.perf_counter() - t0:.1f}s -> {path}", flush=True)
        # reach the device first, so that its start stays out of the timing
        t0 = time.perf_counter()
        torch.zeros(8, device=dev).sum().item()
        print(f"device ready in {time.perf_counter() - t0:.1f}s",
              flush=True)
        exact_ll = exact_ll_of(args.exact_ll, args.ll_mode)
        report = args.report_every or None
        sync(dev)
        t0 = time.perf_counter()
        st = None
        for s in range(args.sources):
            # several sources: the same file counted into source s of one
            # store (the R1/R2 corpus pattern)
            st = counting.count_kmers_fq_sh_rp(
                path, k=args.k, min_q=args.min_q, exact_ll=exact_ll,
                report_every=report, source_n=args.sources, source=s,
                store=st, device=dev)
        t_pipe = time.perf_counter() - t0
        n_unique = st.n_unique
        total = int(st.total_added.sum())
        sync(dev)
        dt = time.perf_counter() - t0
    total_reads = args.reads * args.sources
    print(f"pipeline+flush={t_pipe:.3f}s final fold+sync={dt - t_pipe:.3f}s",
          flush=True)
    print(f"reads={total_reads} k={args.k} exact_ll={exact_ll} "
          f"sources={args.sources} distinct={n_unique} total={total} "
          f"wall={dt:.3f}s rate={total_reads / dt:.0f} reads/s", flush=True)
    tm = st.timings
    rec = {"reads": total_reads, "k": args.k, "read_len": args.read_len,
           "min_q": args.min_q, "exact_ll": exact_ll,
           "binned_quals": args.binned_quals, "sources": args.sources,
           "distinct": n_unique, "total": total, "wall_s": dt,
           "pipeline_s": t_pipe, "reads_per_s": total_reads / dt,
           "reader": tm.get("reader"), "parse_s": tm.get("parse_s"),
           "wait_s": tm.get("wait_s"), "copy_s": tm.get("copy_s"),
           "device": dev.type, "card": card}
    print("COUNTING_STRESS " + json.dumps(rec), flush=True)
    return dict(rec, store=st)


if __name__ == "__main__":
    main()
