"""The benchmark's inputs, drawn from ``--seed``: one general generator that
the traffic and configuration files parameterise.

Every draw runs on the run's device from a ``torch.Generator`` seeded by
:func:`subseed`, in a few large calls, and is copied to the host once where
the program takes host data. The same seed gives the same inputs; another
seed gives other inputs of the same sizes, so the work of a run does not
depend on its seed.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

ACGT = b"ACGT"
ACTG = b"ACTG"  # the 2-bit code order of (byte >> 1) & 3


def subseed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws of a run."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += list(stream.encode())
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(seed: int, stream: str, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(subseed(seed, stream))
    return g


def _table(chars: bytes, dev: torch.device) -> torch.Tensor:
    return torch.tensor(list(chars), dtype=torch.uint8, device=dev)


def genome(length: int, seed: int, dev: torch.device) -> torch.Tensor:
    """Base indices 0..3 (into ``ACGT``) of a uniform random genome."""
    g = generator(seed, "genome", dev)
    return torch.randint(0, 4, (length,), generator=g, device=dev,
                         dtype=torch.uint8)


def read_batches(cfg: dict, seed: int, dev: torch.device
                 ) -> List[Tuple[np.ndarray, ...]]:
    """The configuration's read set as host (seq, qual, lengths, has_qual)
    batches in the native reader's layout: uint8 [rows, width] planes, the
    width the read length rounded up to ``col_multiple`` and padded with
    'N' and 0, int32 lengths, bool has_qual.

    Reads start uniformly on the genome, come from either strand with
    equal odds, carry substitutions at ``sub_rate`` (each to one of the
    three other bases) and qualities drawn from ``qual_bins`` with the
    shares ``qual_shares``."""
    L = int(cfg["read_len"])
    rows = int(cfg["batch_rows"])
    width = -(-L // int(cfg["col_multiple"])) * int(cfg["col_multiple"])
    ref = genome(int(cfg["genome_len"]), seed, dev)
    g = generator(seed, "reads", dev)
    bases, bins = _table(ACGT, dev), _table(cfg["qual_bins"].encode(), dev)
    edges = torch.tensor(np.cumsum(cfg["qual_shares"])[:-1].tolist(),
                         dtype=torch.float32, device=dev)
    n_batches = int(cfg["batches"])
    # one host block for every plane, the batches views of it
    seq_h = np.empty((n_batches, rows, width), np.uint8)
    qual_h = np.empty((n_batches, rows, width), np.uint8)
    lengths = np.full((n_batches, rows), L, np.int32)
    has_qual = np.ones((n_batches, rows), bool)
    for i in range(n_batches):
        start = torch.randint(0, ref.shape[0] - L + 1, (rows, 1),
                              generator=g, device=dev)
        idx = ref[start + torch.arange(L, device=dev)]
        minus = torch.rand((rows, 1), generator=g, device=dev) < 0.5
        idx = torch.where(minus, 3 - idx.flip(1), idx)
        sub = torch.rand((rows, L), generator=g, device=dev) < cfg["sub_rate"]
        shift = torch.randint(1, 4, (rows, L), generator=g, device=dev,
                              dtype=torch.uint8)
        idx = torch.where(sub, (idx + shift) & 3, idx)
        u = torch.rand((rows, L), generator=g, device=dev)
        pick = torch.bucketize(u, edges, right=True)
        seq = torch.full((rows, width), ord("N"), dtype=torch.uint8,
                         device=dev)
        qual = torch.zeros((rows, width), dtype=torch.uint8, device=dev)
        seq[:, :L] = bases[idx.long()]
        qual[:, :L] = bins[pick]
        seq_h[i] = seq.cpu().numpy()
        qual_h[i] = qual.cpu().numpy()
    return [(seq_h[i], qual_h[i], lengths[i], has_qual[i])
            for i in range(n_batches)]


def chromosome(cfg: dict, seed: int, dev: torch.device) -> np.ndarray:
    """A chromosome-like host sequence (uint8): bases drawn uniformly from
    ``alphabet`` (soft-masked case included), ``seq_len // n_run_every``
    runs of N of 1 to ``n_run_max`` bases at uniform offsets, and a unit of
    ``repeat_unit`` uppercase bases tiled ``repeat_copies`` times at
    ``repeat_at``. The last ``n_run_tail`` bases stay free of N."""
    n = int(cfg["seq_len"])
    g = generator(seed, "chromosome", dev)
    alpha = _table(cfg["alphabet"].encode(), dev)
    seq = alpha[torch.randint(0, alpha.shape[0], (n,), generator=g,
                              device=dev)]
    runs = n // int(cfg["n_run_every"])
    at = torch.randint(0, n - int(cfg["n_run_tail"]), (runs,), generator=g,
                       device=dev)
    ln = torch.randint(1, int(cfg["n_run_max"]) + 1, (runs,), generator=g,
                       device=dev)
    # mark each run's bases: +1 at its start, -1 past its end, prefix sum
    mark = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    mark.index_add_(0, at, torch.ones_like(at, dtype=torch.int32))
    mark.index_add_(0, at + ln, -torch.ones_like(at, dtype=torch.int32))
    seq = torch.where(torch.cumsum(mark[:n], 0) > 0, ord("N"), seq)
    unit = _table(ACGT, dev)[torch.randint(0, 4, (int(cfg["repeat_unit"]),),
                                           generator=g, device=dev)]
    r0, copies = int(cfg["repeat_at"]), int(cfg["repeat_copies"])
    seq[r0: r0 + unit.shape[0] * copies] = unit.repeat(copies)
    return seq.to(torch.uint8).cpu().numpy()


def query_plan(traffic: dict, seed: int) -> np.ndarray:
    """[pool, 2] (length, offset fraction) of the query pool: the same set
    for every seed, in an order drawn from the seed.

    Lengths are log-uniform over [min_len, max_len] (the pool's quantiles);
    each carries a fixed fraction of the room left on the sequence for its
    offset (a low-discrepancy sequence), so that every seed queries the
    same places of its own sequence (the planted repeat included) as
    often. The pool is dealt into blocks of ``strata`` that each hold one
    length of every stratum, so every prefix of whole blocks has the same
    mix of lengths."""
    pool, strata = int(traffic["pool"]), int(traffic["strata"])
    if pool % strata:
        raise ValueError("pool must be a multiple of strata")
    lo, hi = math.log10(traffic["min_len"]), math.log10(traffic["max_len"])
    q = (np.arange(pool) + 0.5) / pool
    lengths = np.round(10 ** (lo + (hi - lo) * q))
    frac = (np.arange(pool) * 0.6180339887498949 + 0.5) % 1.0
    plan = np.stack([lengths, frac], 1)
    rng = np.random.default_rng(subseed(seed, "query_order"))
    per = pool // strata  # queries a stratum holds, one for each block
    table = plan.reshape(strata, per, 2)
    table = np.stack([row[rng.permutation(per)] for row in table])
    blocks = [table[rng.permutation(strata), b] for b in range(per)]
    return np.concatenate(blocks)


def query_pool(seq: np.ndarray, traffic: dict, seed: int,
               dev: torch.device) -> List[np.ndarray]:
    """Queries: segments of ``seq`` as :func:`query_plan` places them, with
    substitutions at ``sub_rate`` (never at an N; the new base is
    uppercase), as views into one host array."""
    plan = query_plan(traffic, seed)
    lengths = plan[:, 0].astype(np.int64)
    n = int(seq.shape[0])
    off_h = np.floor(plan[:, 1] * (n - lengths + 1)).astype(np.int64)
    g = generator(seed, "queries", dev)
    off = torch.from_numpy(off_h).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    first = torch.cumsum(ln, 0) - ln
    total = int(lengths.sum())
    flat = (torch.repeat_interleave(off - first, ln)
            + torch.arange(total, device=dev))
    src = torch.from_numpy(seq).to(dev)[flat]
    sub = ((torch.rand(total, generator=g, device=dev) < traffic["sub_rate"])
           & ((src | 0x20) != ord("n")))
    shift = torch.randint(1, 4, (total,), generator=g, device=dev)
    new = _table(ACTG, dev)[(((src.long() >> 1) & 3) + shift) & 3]
    host = torch.where(sub, new, src).cpu().numpy()
    ends = np.cumsum(lengths)
    return [host[e - m: e] for e, m in zip(ends, lengths)]

