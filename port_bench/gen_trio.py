"""The trio configuration's inputs, drawn from ``--seed``: a base genome,
the four haplotypes of the two parents, the child's two, and the three
people's read sets in the native reader's batch layout.

The base genome is :func:`gen.genome`'s, on the same stream. Each parental
haplotype carries single-base substitutions at ``het_rate`` against it.
The child's maternal haplotype is the mother's two joined at
``crossovers`` seeded points, and its paternal one the father's likewise.
A person's reads are drawn as :func:`gen.read_batches` draws them (start,
strand, substitutions at ``sub_rate``, qualities from ``qual_bins`` with
the shares ``qual_shares``), each from one of the person's two haplotypes
with equal odds. Every draw runs on the run's device from a generator
seeded by :func:`gen.subseed`, one named stream a haplotype set and a
person.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from port_bench import gen

PEOPLE = ("child", "mother", "father")  # source 0, 1, 2


def _snvs(base: torch.Tensor, rate: float, g: torch.Generator
          ) -> torch.Tensor:
    """``base`` with each base replaced at ``rate`` by one of the other
    three."""
    hit = torch.rand(base.shape, generator=g, device=base.device) < rate
    shift = torch.randint(1, 4, base.shape, generator=g, device=base.device,
                          dtype=torch.uint8)
    return torch.where(hit, (base + shift) & 3, base)


def _mosaic(a: torch.Tensor, b: torch.Tensor, crossovers: int,
            g: torch.Generator) -> torch.Tensor:
    """A transmitted haplotype: ``a`` and ``b`` joined at ``crossovers``
    points drawn uniformly, which one comes first drawn with equal odds."""
    n, dev = a.shape[0], a.device
    at = torch.randint(1, n, (crossovers,), generator=g, device=dev)
    flips = torch.zeros(n, dtype=torch.int32, device=dev)
    flips.index_add_(0, at, torch.ones_like(at, dtype=torch.int32))
    first_b = torch.randint(0, 2, (1,), generator=g, device=dev,
                            dtype=torch.int32)
    from_b = ((torch.cumsum(flips, 0) + first_b) & 1).bool()
    return torch.where(from_b, b, a)


def haplotypes(cfg: dict, seed: int, dev: torch.device
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Base indices 0..3 (into ``gen.ACGT``) of each person's two
    haplotypes, in :data:`PEOPLE`'s order."""
    base = gen.genome(int(cfg["genome_len"]), seed, dev)
    g = gen.generator(seed, "trio_haplotypes", dev)
    rate = float(cfg["het_rate"])
    mother = (_snvs(base, rate, g), _snvs(base, rate, g))
    father = (_snvs(base, rate, g), _snvs(base, rate, g))
    c = int(cfg["crossovers"])
    child = (_mosaic(*mother, c, g), _mosaic(*father, c, g))
    return [child, mother, father]


def read_batches(haps: Tuple[torch.Tensor, torch.Tensor], cfg: dict,
                 seed: int, stream: str, dev: torch.device
                 ) -> List[Tuple[np.ndarray, ...]]:
    """One person's read set as host (seq, qual, lengths, has_qual)
    batches, as :func:`gen.read_batches` lays them out and draws them, each
    read from haplotype 0 or 1 of ``haps`` with equal odds."""
    L = int(cfg["read_len"])
    rows = int(cfg["batch_rows"])
    width = -(-L // int(cfg["col_multiple"])) * int(cfg["col_multiple"])
    both = torch.stack(haps).reshape(-1)
    n = haps[0].shape[0]
    g = gen.generator(seed, stream, dev)
    bases = gen._table(gen.ACGT, dev)
    bins = gen._table(cfg["qual_bins"].encode(), dev)
    edges = torch.tensor(np.cumsum(cfg["qual_shares"])[:-1].tolist(),
                         dtype=torch.float32, device=dev)
    n_batches = int(cfg["batches"])
    seq_h = np.empty((n_batches, rows, width), np.uint8)
    qual_h = np.empty((n_batches, rows, width), np.uint8)
    lengths = np.full((n_batches, rows), L, np.int32)
    has_qual = np.ones((n_batches, rows), bool)
    cols = torch.arange(L, device=dev)
    for i in range(n_batches):
        start = torch.randint(0, n - L + 1, (rows, 1), generator=g,
                              device=dev)
        hap = torch.randint(0, 2, (rows, 1), generator=g, device=dev)
        idx = both[hap * n + start + cols]
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


def trio(cfg: dict, seed: int, dev: torch.device
         ) -> Tuple[List[list], List[np.ndarray]]:
    """(the three people's read sets in source order, the child's two
    haplotypes as host ASCII bytes)."""
    haps = haplotypes(cfg, seed, dev)
    sources = [read_batches(h, cfg, seed, f"reads_{who}", dev)
               for h, who in zip(haps, PEOPLE)]
    bases = gen._table(gen.ACGT, dev)
    child = [bases[h.long()].cpu().numpy() for h in haps[0]]
    return sources, child
