"""Counting throughput by likelihood mode, with the hybrid flag rate (the
port's twin of ``tools/chip_probes/hybrid_probe.py``).

    python -m kmer_hasher_tpu_torch.probes.hybrid_probe [B [chain]]
        [--device cpu]

Times ``counting._fused_rp_batch`` (B2 -> canonical -> run build) over one
batch of B reads held on the device, ``chain`` times in a row, each after
setting one base of the first read to 'A' (the JAX tool's mutation, which
kept its compiler from merging the calls), in three modes:

  fast    B2 in f32;
  hybrid  B2 in f32 with borderline flags: a flagged read contributes
          nothing here and is re-counted in f64 later (``_sweep_backlog``);
  exact   B2 in f64, bitwise the reference's arithmetic.

Each mode's time is the best of 3 chains after a warm-up, each chain ended
by a synchronisation. The effective hybrid rate composes the measured
rates with the flag rate p: a read costs 1/r_hybrid + p/r_exact, since the
sweep re-counts flagged reads through the exact program.

Quality models, drawn with numpy from ``default_rng(0)`` in this order so
that the batches equal the JAX tool's bit for bit: ``novaseq`` (binned
phred {2, 12, 23, 37}), ``uniform`` (phred 2-40), ``borderline`` ({20, 37}
mixed so that window sums land near min_ll(q20), a worst case for the
flag). K = 21, L = 151, min_q 20.

Prints the card line, one line a mode and model, a flag-rate line a model,
and ``HYBRID_PROBE {json}``.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import counting
from ..index.position_index import resolve_device
from ..ops import encode as enc
from ..qll import Q_TO_LL
from ._common import best_time, card_line

K = 21
L = 151
MIN_Q = 20
MODELS = ("novaseq", "uniform", "borderline")
MODES = ("fast", "hybrid", "exact")
DEAD_HI = 0xFFFFFFFF  # the JAX run's high word where no key is live


def make_batch(rng: np.random.Generator, B: int, qmodel: str, device="cuda"
               ) -> Tuple[torch.Tensor, ...]:
    """(seq, qual, lengths, has_qual) of B reads of L bases on ``device``,
    drawn from ``rng`` as the JAX tool draws them."""
    dev = resolve_device(device)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    if qmodel == "novaseq":
        q = rng.choice(np.array([2, 12, 23, 37]), p=[0.01, 0.03, 0.16, 0.8],
                       size=(B, L))
    elif qmodel == "uniform":
        q = rng.integers(2, 41, size=(B, L))
    elif qmodel == "borderline":
        q = rng.choice(np.array([20, 37]), p=[0.25, 0.75], size=(B, L))
    else:
        raise ValueError(f"unknown quality model {qmodel!r}")
    qual = (q + 33).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    return (torch.from_numpy(seq).to(dev), torch.from_numpy(qual).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.ones(B, dtype=torch.bool, device=dev))


def head_hi(keys: torch.Tensor):
    """The high 32 bits of a run's smallest raw key (the JAX run's
    ``r_hi[0]``), DEAD_HI for an empty run."""
    if keys.shape[0] == 0:
        return DEAD_HI
    return (enc.sortable_key(keys[0]) >> 32) & 0xFFFFFFFF


def chained(batch, mode: str, chain: int):
    """``chain`` fused batches of a copy of ``batch``, base (0, i % L) set
    to 'A' before call i: (sum of each run's head_hi and observation count,
    sum of the flags), as int64 tensors on the batch's device."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    seq, qual, lengths, has_qual = batch
    seq = seq.clone()
    min_ll_f = float(Q_TO_LL[33 + MIN_Q])
    acc = torch.zeros((), dtype=torch.int64, device=seq.device)
    nflag = torch.zeros((), dtype=torch.int64, device=seq.device)
    for i in range(chain):
        seq[0, i % L] = ord("A")
        keys, _cnt, n_obs, _flags, n_flag = counting._fused_rp_batch(
            seq, qual, lengths, has_qual, K, 1, 0, min_ll_f, mode,
            min_q_char=33 + MIN_Q)
        acc = acc + head_hi(keys) + n_obs
        nflag = nflag + n_flag
    return acc, nflag


def run(B: int = 16384, chain: int = 8, device="cuda") -> dict:
    """Every model and mode; prints the lines and returns the JSON line's
    record."""
    dev = resolve_device(device)
    card = card_line(dev)
    print(card, flush=True)
    print(f"device ready ({dev.type}), B={B}, chain={chain}, k={K}, L={L}, "
          f"min_q={MIN_Q}", flush=True)
    rng = np.random.default_rng(0)
    reads = B * chain
    rec = {"B": B, "chain": chain, "k": K, "L": L, "min_q": MIN_Q,
           "device": dev.type, "card": card, "models": {}}
    for qmodel in MODELS:
        batch = make_batch(rng, B, qmodel, dev)
        m = {"s": {}, "reads_per_s": {}, "acc": {}, "flags": {}}
        for mode in MODES:
            dt, (acc, nflag) = best_time(lambda: chained(batch, mode, chain),
                                         dev)
            m["s"][mode] = dt
            m["reads_per_s"][mode] = reads / dt
            m["acc"][mode] = int(acc)
            m["flags"][mode] = int(nflag)
            print(f"  {qmodel:10s} {mode:13s}: {dt * 1e3:8.1f} ms chained "
                  f"-> {reads / dt / 1e6:7.3f} M reads/s", flush=True)
        flagged = m["flags"]["hybrid"]
        p = flagged / reads
        t_eff = 1.0 / m["reads_per_s"]["hybrid"] + p / m["reads_per_s"][
            "exact"]
        m.update(flagged=flagged, p=p, effective_hybrid_reads_per_s=1 / t_eff)
        print(f"  {qmodel:10s} flag rate p={p:.5f} ({flagged}/{reads} reads) "
              f"-> effective hybrid {1.0 / t_eff / 1e6:.3f} M reads/s "
              f"(bit-parity)", flush=True)
        rec["models"][qmodel] = m
    print("HYBRID_PROBE " + json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=16384)
    ap.add_argument("chain", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.B, args.chain, args.device)


if __name__ == "__main__":
    main()
