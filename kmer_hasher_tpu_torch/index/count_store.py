"""Multi-source k-mer count store (PyTorch port of
``kmer_hasher_tpu/index/count_store.py``) — the sorted-array replacement
for the reference's counting backends (``kmer_tree`` src/kmer_tree.c,
``suffix_hash`` / ``suffix_hash_n`` src/suffix_hash.c).

Counts live in **size-tiered sorted runs** (an LSM), as in the JAX package:

* a deferred batch becomes a *run* — sort + segment-reduce of the batch;
* two runs of one capacity class merge pairwise (binomial-heap style), so
  each observation takes part in O(log(N/B)) merges;
* a read folds every run into one sorted base table, kept until the next
  add.

What differs from the JAX package is the run's form, not its content. A
run here is its live rows only: sorted unique keys and an [n, counts_n]
count block, of whatever length it has. Eager PyTorch has no compiled
program per shape to protect, so there is no power-of-two padding, no dead
row, no all-ones sentinel (and so no special case for a real all-G 32-mer),
no shadow row, no key-only form and no deferred trim. The price is one
host sync per run built or merged, where the run's length is read back.

Keys are ``ops.encode.sortable_key`` of the raw int64 patterns, so their
signed order is the unsigned order of the k-mers. A tier merge is concat +
``torch.sort`` + neighbour add (each key occurs at most twice); the
hand-written merge of two sorted runs takes its place in a later change.

Counts are exact integers held in **int64**: PyTorch on the CPU lacks most
uint32 arithmetic, ``torch.bincount`` wants int64, and sums never wrap. The
npz checkpoint holds them as uint32 and ``lookup`` gives int32 rows, as the
JAX package does.

Count semantics match ``suffix_hash_n`` (src/suffix_hash.c:180-281): up to
``counts_n`` per-source counters per k-mer. The ``kmer_tree`` mode differs
only in spectra: its dense blocks contribute their zero cells
(src/kmer_tree.c:85-99), modelled by prefix-block accounting.

Not ported yet: host/disk spill with the ranged fold, and
``budget_semantics="drop"``; the constructor refuses both.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import encode as enc
from .position_index import resolve_device

Run = Tuple[torch.Tensor, torch.Tensor]  # (sortable keys [n], counts [n, C])


def lsm_compact(runs: list, cap_of: Callable, merge_two: Callable) -> list:
    """Size-tiered LSM compaction policy: merge runs of equal capacity
    class pairwise until all classes are distinct (binomial-heap invariant
    — at most O(log N) runs, each observation in O(log(N/B)) merges).
    ``cap_of`` reads a run's class; ``merge_two`` merges two runs."""
    while True:
        by_cap: dict = {}
        for i, r in enumerate(runs):
            by_cap.setdefault(cap_of(r), []).append(i)
        pair = next((v for v in by_cap.values() if len(v) >= 2), None)
        if pair is None:
            return runs
        i, j = pair[0], pair[1]
        merged = merge_two(runs[i], runs[j])
        runs = [r for t, r in enumerate(runs) if t not in (i, j)]
        runs.append(merged)


def _cap_class(run: Run) -> int:
    """A run's capacity class: the power-of-two bucket of its length."""
    return max(int(run[0].shape[0]) - 1, 0).bit_length()


def _segment_starts(keys: torch.Tensor) -> torch.Tensor:
    """True at the first row of each equal-key group of sorted keys."""
    starts = torch.ones_like(keys, dtype=torch.bool)
    starts[1:] = keys[1:] != keys[:-1]
    return starts


def build_run(keys: torch.Tensor, counts_n: int, source: int) -> Run:
    """Sortable keys of one batch's valid observations (any order, with
    repeats) -> a run: ``torch.sort`` + segment-reduce. The count of a key
    is its group's length, in column ``source``."""
    s = torch.sort(keys).values
    first = torch.nonzero(_segment_starts(s)).squeeze(1)
    n = torch.empty_like(first)
    n[:-1] = first[1:] - first[:-1]
    n[-1:] = s.shape[0] - first[-1:]
    cnt = torch.zeros((first.shape[0], counts_n), dtype=torch.int64,
                      device=keys.device)
    cnt[:, source] = n
    return s[first], cnt


def reduce_rows(keys: torch.Tensor, cnt: torch.Tensor) -> Run:
    """Any (sortable key, count row) table, unsorted and with repeats, ->
    a run: ``torch.sort`` + a segmented sum of the count rows, taken as a
    prefix sum differenced at the group ends (exact in int64, no atomics)."""
    s, order = torch.sort(keys)
    first = torch.nonzero(_segment_starts(s)).squeeze(1)
    total = torch.cumsum(cnt[order], dim=0)
    last = torch.empty_like(first)
    last[:-1] = first[1:] - 1
    last[-1:] = s.shape[0] - 1
    seg = total[last]
    seg[1:] -= total[last[:-1]]
    return s[first], seg


def merge_runs(runs: Sequence[Run]) -> Run:
    """Merge runs (each with unique sorted keys) into one. Two runs — the
    tier merge: concat + ``torch.sort`` + neighbour add, since a key occurs
    at most twice. More — the fold: :func:`reduce_rows` of all rows."""
    keys = torch.cat([r[0] for r in runs])
    cnt = torch.cat([r[1] for r in runs])
    if len(runs) != 2:
        return reduce_rows(keys, cnt)
    s, order = torch.sort(keys)
    cnt = cnt[order]
    starts = _segment_starts(s)
    nxt_same = torch.zeros_like(starts)
    nxt_same[:-1] = ~starts[1:]
    absorb = torch.zeros_like(cnt)
    absorb[:-1] = cnt[1:]
    cnt = cnt + absorb * nxt_same[:, None]
    return s[starts], cnt[starts]


class CountStore:
    """Sorted multi-source count table (``suffix_hash_n`` analogue) on
    ``device``.

    mode: 'sh' (suffix_hash / suffix_hash_n semantics — spectra over present
    k-mers), 'ktree' (kmer_tree — spectra include the zero cells of
    allocated prefix blocks), or 'khash' (the in-memory ``count.kmers``
    store — no prefix structure).

    K-mers go in and out as raw int64 patterns (``ops.encode``); the base
    table ``keys`` holds their sortable form, ``cnt`` the int64 count rows.
    ``timings`` accumulates the host seconds spent in tier merges and in
    folds, each ending in the sync that reads the run's length.
    """

    def __init__(self, k: int, counts_n: int = 1, prefix_bits: int = 0,
                 suffix_bits: Optional[int] = None, mode: str = "sh",
                 max_size_bytes: Optional[int] = None,
                 budget_semantics: str = "error",
                 spill_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None, device="cuda"):
        if not 1 <= k <= 32:
            raise ValueError("k must be in 1..32")
        if counts_n < 1:
            raise ValueError("counts_n must be >= 1")
        if mode not in ("sh", "ktree", "khash"):
            raise ValueError(f"unknown mode {mode!r}")
        if budget_semantics not in ("error", "drop"):
            raise ValueError(f"unknown budget_semantics {budget_semantics!r}")
        if budget_semantics == "drop":
            raise NotImplementedError(
                "budget_semantics='drop' is not ported yet")
        if spill_bytes is not None or spill_dir is not None:
            raise NotImplementedError(
                "host/disk spill (spill_bytes, spill_dir) is not ported yet")
        self.k = int(k)
        self.counts_n = int(counts_n)
        self.prefix_bits = int(prefix_bits)
        if suffix_bits is None:
            # the reference's clamp (src/suffix_hash.c:19-21,
            # kmer_reader.c:86-95): suffix <= 32, prefix absorbs the rest
            sb = min(2 * k - self.prefix_bits, 32)
            self.suffix_bits = sb
            self.prefix_bits = 2 * k - sb
        else:
            self.suffix_bits = int(suffix_bits)
        if not 0 <= self.prefix_bits <= 36:
            raise ValueError("prefix_bits must be in 0..36")
        if not 0 <= self.suffix_bits <= 32:
            raise ValueError(
                "suffix_bits must be in 0..32 (got "
                f"{self.suffix_bits}; clamp prefix_bits for small k)")
        self.mode = mode
        self.max_size_bytes = max_size_bytes
        self.budget_semantics = budget_semantics
        self.device = resolve_device(device)
        self.keys = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.cnt = torch.zeros((0, self.counts_n), dtype=torch.int64,
                               device=self.device)
        self._total_added = np.zeros(self.counts_n, np.int64)
        self._pending: List[Tuple[torch.Tensor, int]] = []
        self._pending_n = 0
        self._runs: List[Run] = []
        # build a run once this many valid observations are pending
        self.run_build_size = 1 << 16
        self.timings = {"tier_merges": 0, "tier_merge_s": 0.0,
                        "tier_merge_rows": 0, "folds": 0, "fold_s": 0.0}

    # -- adds -----------------------------------------------------------------
    @property
    def total_added(self) -> np.ndarray:
        """Observations added per source, int64 [counts_n]."""
        return self._total_added.copy()

    def add_kmers(self, raw: torch.Tensor, valid: torch.Tensor,
                  source: int = 0, defer: bool = False) -> "CountStore":
        """Merge a batch of observed k-mers (raw patterns, any shape) into
        the store; ``valid`` masks the real observations.

        With ``defer=True`` the batch is queued; queued work becomes a
        sorted run once ``run_build_size`` observations accumulate, and
        runs of one capacity class merge pairwise. Any query folds the
        runs first. An eager add is a deferred add followed by a flush."""
        if not 0 <= source < self.counts_n:
            raise ValueError("source out of range")
        keys = enc.sortable_key(raw.to(self.device).reshape(-1)
                                [valid.to(self.device).reshape(-1)])
        n = int(keys.shape[0])
        self._total_added[source] += n
        if n:
            self._pending.append((keys, source))
            self._pending_n += n
        if not defer:
            self.flush()
        elif self._pending_n >= self.run_build_size:
            self._build_runs()
        return self

    def add_run(self, keys: torch.Tensor, cnt: torch.Tensor, n_obs: int,
                source: int = 0) -> "CountStore":
        """Append a prebuilt run — sorted unique sortable keys [n] with
        int64 count rows [n, counts_n] — and re-balance the tiers.
        ``n_obs`` is the number of observations of ``source`` folded into
        the run, accounted into total_added."""
        if not 0 <= source < self.counts_n:
            raise ValueError("source out of range")
        if cnt.shape != (keys.shape[0], self.counts_n):
            raise ValueError("count rows do not match the keys")
        self._total_added[source] += int(n_obs)
        if keys.shape[0]:
            self._runs.append((keys.to(self.device),
                               cnt.to(self.device, torch.int64)))
            self._compact_tiers()
        return self

    def _build_runs(self) -> None:
        """Turn pending batches into sorted runs (one per source present)
        and re-balance the tiers."""
        if not self._pending:
            return
        by_source: dict = {}
        for keys, source in self._pending:
            by_source.setdefault(source, []).append(keys)
        self._pending = []
        self._pending_n = 0
        for source, batches in sorted(by_source.items()):
            self._runs.append(
                build_run(torch.cat(batches), self.counts_n, source))
        self._compact_tiers()

    def _merge_two(self, a: Run, b: Run) -> Run:
        t0 = time.perf_counter()
        out = merge_runs((a, b))
        self.timings["tier_merges"] += 1
        self.timings["tier_merge_rows"] += int(a[0].shape[0] + b[0].shape[0])
        self.timings["tier_merge_s"] += time.perf_counter() - t0
        return out

    def _compact_tiers(self) -> None:
        self._runs = lsm_compact(self._runs, _cap_class, self._merge_two)

    def flush(self) -> "CountStore":
        """Fold pending batches and all runs into the sorted base table."""
        self._build_runs()
        if not self._runs:
            return self
        t0 = time.perf_counter()
        runs = self._runs + ([(self.keys, self.cnt)] if self.n_rows else [])
        self._runs = []
        self.keys, self.cnt = runs[0] if len(runs) == 1 else merge_runs(runs)
        self.timings["folds"] += 1
        self.timings["fold_s"] += time.perf_counter() - t0
        self._check_budget()
        return self

    def _check_budget(self) -> None:
        """Soft memory budget like kmer_tree's max_size (kmer_tree.c:57-67):
        the estimated dense-block footprint must stay under the cap. The
        reference stops allocating blocks and silently drops their k-mers;
        this raises after the fold that first exceeds."""
        if self.max_size_bytes is None or self.mode != "ktree":
            return
        est = self.n_alloc_blocks() * 4 * (1 << self.suffix_bits)
        if est > self.max_size_bytes:
            raise MemoryError(
                f"kmer_tree budget exceeded: estimated {est} bytes > "
                f"max_size {self.max_size_bytes}")

    # -- sizes ----------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        """Rows of the base table as it stands (no fold)."""
        return int(self.keys.shape[0])

    @property
    def n_unique(self) -> int:
        """Distinct k-mers; folds pending runs when there are any."""
        self.flush()
        return self.n_rows

    def peek_n_unique(self) -> int:
        """Exact distinct-key count WITHOUT installing a new base table:
        the keys of every run and of the base are sorted together and their
        groups counted; the tiers stay as they are. Progress meters use
        this."""
        self._build_runs()
        if not self._runs:
            return self.n_rows
        keys = torch.cat([r[0] for r in self._runs] + [self.keys])
        return int(_segment_starts(torch.sort(keys).values).sum())

    def n_alloc_blocks(self) -> int:
        """Distinct prefixes (k-mer >> suffix_bits) among the stored
        k-mers — the reference's allocated-block count."""
        self.flush()
        if not self.n_rows:
            return 0
        raw = enc.sortable_key(self.keys)
        sb = self.suffix_bits
        pref = raw if sb == 0 else (raw >> sb) & ((1 << (64 - sb)) - 1)
        return int(_segment_starts(pref).sum())

    # -- queries --------------------------------------------------------------
    def lookup(self, q_raw: torch.Tensor) -> torch.Tensor:
        """Per-query count rows, int32 [n, counts_n] on the store's device;
        zeros for absent k-mers (sh_kmer_count_n semantics,
        src/suffix_hash.c:283-332)."""
        self.flush()
        q = enc.sortable_key(q_raw.to(self.device).reshape(-1))
        if not self.n_rows:
            return torch.zeros((q.shape[0], self.counts_n),
                               dtype=torch.int32, device=self.device)
        at = torch.searchsorted(self.keys, q).clamp(max=self.n_rows - 1)
        found = self.keys[at] == q
        return (self.cnt[at] * found[:, None]).to(torch.int32)

    def counts_dict(self) -> dict:
        """Host export: packed k-mer (unsigned) -> count row (tests, small
        stores)."""
        self.flush()
        raw = enc.sortable_key(self.keys).cpu().numpy().view(np.uint64)
        cnt = self.cnt.cpu().numpy()
        return {int(kk): cnt[i].tolist() for i, kk in enumerate(raw)}

    # -- spectra --------------------------------------------------------------
    def spectrum(self, max_count: int) -> np.ndarray:
        """kmer.spec.kt / kmer.spec.sh (src/kmer_hash.c:975-1008): histogram
        of source-0 counts, clamped into the last bin; float64
        [max_count + 1] on the host. 'ktree' stores add the zero cells of
        their allocated prefix blocks to bin 0."""
        if not 1 <= max_count <= (1 << 30):
            raise ValueError("Unsuitable value of max_count")
        self.flush()
        spec = torch.bincount(self.cnt[:, 0].clamp(max=max_count),
                              minlength=max_count + 1)
        spec = spec.cpu().numpy().astype(np.float64)
        if self.mode == "ktree":
            cells = self.n_alloc_blocks() << self.suffix_bits
            spec[0] += float(cells - self.n_rows)
        return spec

    def spectrum_n(self, max_count: int, comb: Sequence[int],
                   comb_inner: Sequence[int],
                   source_min: Sequence[int]) -> np.ndarray:
        """kmer.spec.sh.n (src/kmer_hash.c:1010-1038, sh_count_spectrum_nc
        src/suffix_hash.c:335-425): (comb_n*counts_n) x (max_count+1)
        combination spectra, float64 on the host."""
        comb = np.asarray(comb, np.int32)
        comb_inner = np.asarray(comb_inner, np.int32)
        source_min = np.asarray(source_min, np.int64)
        if comb_inner.shape != comb.shape:
            raise ValueError("comb_inner must match comb in length")
        if len(source_min) != self.counts_n:
            raise ValueError("source_min must have counts_n entries")
        if ((comb_inner < 0) | (comb_inner > 1)).any():
            raise ValueError("comb_inner values must be 0 or 1")
        if (comb >= (1 << self.counts_n)).any():
            raise ValueError("comb values must be < 2^counts_n")
        self.flush()
        C = self.counts_n
        smin = torch.from_numpy(source_min).to(self.device)
        bit = 1 << torch.arange(C, device=self.device)
        flags = ((self.cnt >= smin[None, :]) * bit[None, :]).sum(dim=1)
        cl = self.cnt.clamp(max=max_count)
        out = np.zeros((len(comb) * C, max_count + 1), np.float64)
        for jj, (cb, inner) in enumerate(zip(comb.tolist(),
                                             comb_inner.tolist())):
            sel = (flags == cb) if inner == 1 else ((flags & cb) > 0)
            rows = cl[sel]
            for s in range(C):
                out[jj * C + s] = torch.bincount(
                    rows[:, s], minlength=max_count + 1).cpu().numpy()
        return out
