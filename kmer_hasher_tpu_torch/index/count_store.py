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
signed order is the unsigned order of the k-mers. A merge of two runs — a
tier merge, or a fold of exactly two — goes through kernel B3
(``ops/cuda_merge.py``): the two sorted key arrays are merged with the
row number as payload, the count rows are gathered by it, and equal
neighbours are added (each key occurs at most twice, A's row first). A
fold of more than two runs is ``torch.sort`` + a segmented sum, as the JAX
package's fold is not its Pallas kernel either.

Counts are exact integers held in **int64**: PyTorch on the CPU lacks most
uint32 arithmetic, ``torch.bincount`` wants int64, and sums never wrap. The
npz checkpoint holds them as uint32 and ``lookup`` gives int32 rows, as the
JAX package does.

Count semantics match ``suffix_hash_n`` (src/suffix_hash.c:180-281): up to
``counts_n`` per-source counters per k-mer. The ``kmer_tree`` mode differs
only in spectra: its dense blocks contribute their zero cells
(src/kmer_tree.c:85-99), modelled by prefix-block accounting.

**Spill.** With ``spill_bytes`` set, whenever the resident runs occupy more
than that on the device (8 bytes per key and 8 per counter, what they
really take), the largest run leaves for host memory, or for one ``.npz``
file under ``spill_dir``. A spilled run is its live rows, like any run:
no padding, no dead tail. Device-to-host and host-to-device copies of a
CUDA store go through two pinned staging buffers of a fixed size, reused
for every spill and rejoin. A fold rejoins the spilled runs one at a time
through B3, or, when the table is too large for one merge's workspace,
**by key range** (:meth:`CountStore._fold_spilled_ranged`): every run goes
to the host, splitters are taken at evenly spaced ranks of the largest
run, and each range is merged in one pass of its own
(:meth:`CountStore._merge_range`): the ``searchsorted`` slice of every
host run goes up, all of the range's slices back to back through the
pinned buffers, B3 merges them in rounds that each merge every pair of
runs in one launch, and one gather, one collapse of equal keys and one
readback make the range's piece; the pieces concatenate into the base
table. The pass is apart from :func:`merge_runs`, which the tier merges
and the plain rejoin keep. The fold budget says when: the
store's ``fold_budget_bytes`` where it is given (on any device, the CPU
included), else :func:`_fold_budget_bytes`. A ranged fold is bitwise the
plain one.

**Drop.** ``budget_semantics="drop"`` (``mode="ktree"`` with
``max_size_bytes``) is the reference's silent budget (src/kmer_tree.c:51-76):
the first ``max_size // block bytes`` distinct prefixes to appear get
blocks, k-mers of every later prefix are dropped and counted nowhere.
Admission walks the host with numpy (a fidelity mode, no kernel): a raw
stream admits in stream order, a prebuilt run in key order (the JAX
package's PARITY deviation 7). The runs stay on the device.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_merge
from ..ops import encode as enc
from ..utils.trace import span
from .position_index import resolve_device

Run = Tuple[torch.Tensor, torch.Tensor]  # (sortable keys [n], counts [n, C])

# Device bytes a two-run merge occupies at its peak, over the bytes of its
# two inputs: counted from what merge_runs allocates per input row with one
# counter (16 bytes) — the inputs, the concatenated keys (8), B3's merged
# keys and payload (12), the gathered count rows (8), the neighbour add's
# shifted copy, product and sum (24), two masks (2) and the compaction's
# row indices and outputs (up to 24): 70-80 bytes. chip_smoke.py measures it
# (4.60 at 7,000,000 + 4,000,000 rows on an H100 80GB HBM3).
MERGE_PEAK_FACTOR = 5
_STAGE_BYTES = 32 << 20  # each of the two pinned staging buffers


def _fold_budget_bytes(dev: torch.device) -> int:
    """Device bytes one merge of the spill rejoin may occupy, inputs and
    workspace together. A rejoin whose largest merge would need more (its
    input rows x MERGE_PEAK_FACTOR) goes by key range instead, in ranges
    sized to fit. ``KMH_FOLD_BUDGET_BYTES`` sets it (read at call time;
    tests force it tiny). The default is half the device's memory: the
    other half is for the folded table itself, which the ranged fold holds
    twice while it concatenates its pieces. A CPU store has no device
    memory to protect and never goes ranged unless the variable says so."""
    env = os.environ.get("KMH_FOLD_BUDGET_BYTES")
    if env is not None:
        return int(env)
    if dev.type != "cuda":
        return 1 << 62
    return torch.cuda.get_device_properties(dev).total_memory // 2


class _Staging:
    """Host <-> device copies of a run's tensors. For a CUDA device they go
    in chunks through two pinned host buffers, allocated at first use and
    reused for every spill and rejoin: the copy of one chunk overlaps the
    host's move of the other, and the run itself lives in ordinary (pageable)
    host memory of exactly its size. The copies and their events go on the
    store's device's current stream, whichever device is current. For a CPU
    store both directions are the identity.

    On a CUDA store every call adds its bytes and host seconds to
    ``timings["staging_bytes"]`` and ``timings["staging_s"]``, with no
    synchronisation of its own: ``cat_to_device`` returns before its last
    chunk (at most ``_STAGE_BYTES``) lands."""

    def __init__(self, dev: torch.device, timings: dict):
        self.dev = dev
        self.timings = timings
        self._bufs: Optional[list] = None
        self._events: Optional[list] = None

    def _pinned(self):
        if self._bufs is None:
            self._bufs = [torch.empty(_STAGE_BYTES, dtype=torch.uint8,
                                      pin_memory=True) for _ in range(2)]
            self._events = [torch.cuda.Event() for _ in range(2)]
        return self._bufs, self._events

    @staticmethod
    def _chunks(n: int):
        return [(a, min(a + _STAGE_BYTES, n))
                for a in range(0, n, _STAGE_BYTES)]

    def _count(self, nbytes: int, t0: float) -> None:
        self.timings["staging_bytes"] += nbytes
        self.timings["staging_s"] += time.perf_counter() - t0

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        if self.dev.type != "cuda":
            return t
        t0 = time.perf_counter()
        out = torch.empty(t.shape, dtype=t.dtype)
        src = t.contiguous().reshape(-1).view(torch.uint8)
        dst = out.reshape(-1).view(torch.uint8)
        bufs, events = self._pinned()
        chunks = self._chunks(src.numel())
        for i in range(len(chunks) + 1):
            if i < len(chunks):  # start chunk i on its way to buffer i % 2
                a, b = chunks[i]
                events[i % 2].synchronize()  # an earlier upload has left it
                bufs[i % 2][: b - a].copy_(src[a:b], non_blocking=True)
                events[i % 2].record(torch.cuda.current_stream(self.dev))
            if i:  # meanwhile move chunk i - 1 out of the other buffer
                a, b = chunks[i - 1]
                events[(i - 1) % 2].synchronize()
                dst[a:b].copy_(bufs[(i - 1) % 2][: b - a])
        self._count(src.numel(), t0)
        return out

    def cat_to_device(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Host tensors of one dtype and row shape -> their concatenation on
        the device. A CUDA store packs the parts' bytes into the pinned
        buffers one after another, so every copy but the last is a whole
        buffer, however small the parts; a CPU store concatenates."""
        if self.dev.type != "cuda":
            return torch.cat(list(parts))
        t0 = time.perf_counter()
        rows = sum(int(p.shape[0]) for p in parts)
        out = torch.empty((rows,) + tuple(parts[0].shape[1:]),
                          dtype=parts[0].dtype, device=self.dev)
        dst = out.reshape(-1).view(torch.uint8)
        srcs = [p.contiguous().reshape(-1).view(torch.uint8) for p in parts]
        bufs, events = self._pinned()
        j = u = 0  # the next byte to pack: srcs[j][u]
        for i, (a, b) in enumerate(self._chunks(dst.numel())):
            events[i % 2].synchronize()  # the buffer's last copy has left it
            x = 0
            while x < b - a:
                take = min(b - a - x, srcs[j].numel() - u)
                bufs[i % 2][x: x + take].copy_(srcs[j][u: u + take])
                x, u = x + take, u + take
                if u == srcs[j].numel():
                    j, u = j + 1, 0
            dst[a:b].copy_(bufs[i % 2][: b - a], non_blocking=True)
            events[i % 2].record(torch.cuda.current_stream(self.dev))
        self._count(dst.numel(), t0)
        return out


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
    """Merge runs (each with unique sorted keys) into one. Two runs: B3
    merges the key arrays with the row number as payload, the count rows
    follow by a gather, and a key present in both runs (its two rows are
    neighbours, A's first) keeps one row with the sum. More: the fold,
    :func:`reduce_rows` of all rows."""
    keys = torch.cat([r[0] for r in runs])
    cnt = torch.cat([r[1] for r in runs])
    if len(runs) != 2:
        return reduce_rows(keys, cnt)
    na = int(runs[0][0].shape[0])
    s, src = cuda_merge.merge(keys, None, (0, na, int(keys.shape[0])))
    cnt = cnt.index_select(0, src)
    starts = _segment_starts(s)
    nxt_same = torch.zeros_like(starts)
    nxt_same[:-1] = ~starts[1:]
    absorb = torch.zeros_like(cnt)
    absorb[:-1] = cnt[1:]
    cnt = cnt + absorb * nxt_same[:, None]
    return s[starts], cnt[starts]


def collapse_sorted(s: torch.Tensor, cnt: torch.Tensor) -> Run:
    """Sorted keys with repeats and their count rows -> a run: each
    equal-key group's key and the sum of its rows, a prefix sum (taken in
    place) differenced at the group ends, exact in int64. The nonzero of
    the group starts is its one synchronisation."""
    first = torch.nonzero(_segment_starts(s)).squeeze(1)
    total = cnt.cumsum_(0)
    last = torch.empty_like(first)
    last[:-1] = first[1:] - 1
    last[-1:] = s.shape[0] - 1
    seg = total[last]
    seg[1:] -= total[last[:-1]]
    return s[first], seg


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
    folds, each ending in the sync that reads the run's length;
    ``fold_merges`` counts the two-run merges that folds made — a fold of
    exactly two runs, each rejoin of a spilled run — and ``range_rounds``
    the B3 launches of ranged folds (ceil(log2 S) a range of S slices), so
    B3 runs ``tier_merges + fold_merges + range_rounds`` times.
    ``spills``, ``spill_s`` and ``spilled_rows`` account for the runs
    that left the device, ``ranged_folds`` and ``ranges`` for the folds
    that went by key range and the non-empty ranges they merged.
    ``rejoin_s`` and ``rejoined_rows`` are the host seconds inside
    ``kmh.store.rejoin`` (the spilled runs, or a ranged fold's slices,
    back to the device and their merges) and the rows uploaded there;
    ``staging_bytes`` and ``staging_s`` the bytes and host seconds of every
    copy through the pinned staging buffers (a CUDA store only).
    ``spectrum_n_s`` is the host seconds inside ``kmh.store.spectrum_n``
    (:meth:`spectrum_n`, its readbacks included); ``depth_s`` and
    ``depth_windows`` the host seconds inside ``kmh.count.depth`` and the
    window starts of the sequences looked up there
    (``counting.seq_kmer_depth``).

    ``spill_bytes`` / ``spill_dir`` / ``fold_budget_bytes`` and
    ``budget_semantics`` are described in the module's docstring.
    """

    def __init__(self, k: int, counts_n: int = 1, prefix_bits: int = 0,
                 suffix_bits: Optional[int] = None, mode: str = "sh",
                 max_size_bytes: Optional[int] = None,
                 budget_semantics: str = "error",
                 spill_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 fold_budget_bytes: Optional[int] = None, device="cuda"):
        if not 1 <= k <= 32:
            raise ValueError("k must be in 1..32")
        if counts_n < 1:
            raise ValueError("counts_n must be >= 1")
        if mode not in ("sh", "ktree", "khash"):
            raise ValueError(f"unknown mode {mode!r}")
        if budget_semantics not in ("error", "drop"):
            raise ValueError(f"unknown budget_semantics {budget_semantics!r}")
        if budget_semantics == "drop" and (mode != "ktree"
                                           or max_size_bytes is None):
            raise ValueError("budget_semantics='drop' requires mode='ktree' "
                             "and max_size_bytes")
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
        self._admitted: Optional[np.ndarray] = None  # sorted uint64 prefixes
        self._admit_frozen = False
        self.device = resolve_device(device)
        self.keys, self.cnt = self._empty_table()
        self._total_added = np.zeros(self.counts_n, np.int64)
        self._pending: List[Tuple[torch.Tensor, int]] = []
        self._pending_n = 0
        self._runs: List[Run] = []
        # build a run once this many valid observations are pending
        self.run_build_size = 1 << 16
        self.spill_bytes = spill_bytes
        self.spill_dir = spill_dir
        self.fold_budget_bytes = fold_budget_bytes
        # runs off the device: ('mem', (keys, cnt) on the host) or
        # ('file', path of an .npz with those two arrays)
        self._spilled: List[Tuple[str, object]] = []
        self._spilled_rows = 0
        self._spill_seq = 0
        self.timings = {"tier_merges": 0, "tier_merge_s": 0.0,
                        "tier_merge_rows": 0, "folds": 0, "fold_merges": 0,
                        "range_rounds": 0,
                        "fold_s": 0.0, "spills": 0, "spill_s": 0.0,
                        "spilled_rows": 0, "ranged_folds": 0, "ranges": 0,
                        "rejoin_s": 0.0, "rejoined_rows": 0,
                        "staging_bytes": 0, "staging_s": 0.0,
                        "spectrum_n_s": 0.0, "depth_s": 0.0,
                        "depth_windows": 0}
        self._staging = _Staging(self.device, self.timings)

    def _empty_table(self) -> Run:
        return (torch.zeros(0, dtype=torch.int64, device=self.device),
                torch.zeros((0, self.counts_n), dtype=torch.int64,
                            device=self.device))

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
        if self.budget_semantics == "drop":
            # a raw stream carries its true order, so admission here is the
            # reference's per-k-mer allocation walk exactly
            pref = self._prefixes(raw.reshape(-1))
            v_h = valid.reshape(-1).cpu().numpy().astype(bool)
            self._admit_prefixes(pref[v_h])
            valid = torch.from_numpy(v_h & np.isin(pref, self._admitted))
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
        keys, cnt = keys.to(self.device), cnt.to(self.device, torch.int64)
        self._total_added[source] += int(n_obs)
        if self.budget_semantics == "drop" and keys.shape[0]:
            keys, cnt = self._budget_filter_run(keys, cnt)
        if keys.shape[0]:
            self._runs.append((keys, cnt))
            self._compact_tiers()
        return self

    # -- ktree 'drop' budget semantics (src/kmer_tree.c:51-76) ----------------
    @property
    def _budget_blocks(self) -> int:
        """How many dense prefix blocks the budget pays for."""
        return int(self.max_size_bytes) // (4 << self.suffix_bits)

    def _prefixes(self, raw: torch.Tensor) -> np.ndarray:
        """Raw int64 patterns -> their prefixes (k-mer >> suffix_bits) as
        unsigned numbers on the host."""
        return (raw.cpu().numpy().view(np.uint64)
                >> np.uint64(self.suffix_bits))

    def _admit_prefixes(self, pref_stream: np.ndarray) -> None:
        """Admit new prefixes, in first-occurrence order of ``pref_stream``,
        until the block budget fills; a batch that brings more new prefixes
        than there is room freezes the admitted set for ever (the reference
        can never allocate another block once one was refused)."""
        if self._admitted is None:
            self._admitted = np.empty(0, np.uint64)
        if self._admit_frozen:
            return
        uniq, first = np.unique(pref_stream, return_index=True)
        fresh = ~np.isin(uniq, self._admitted)
        new, first = uniq[fresh], first[fresh]
        if not new.size:
            return
        new = new[np.argsort(first, kind="stable")]
        space = self._budget_blocks - self._admitted.size
        if new.size > space:
            self._admit_frozen = True
        self._admitted = np.union1d(self._admitted, new[:max(0, space)])

    def _budget_filter_run(self, keys: torch.Tensor, cnt: torch.Tensor
                           ) -> Run:
        """Drop-mode filter of a run: admit its prefixes in KEY order (the
        run has no stream order left) and strip the rows of prefixes without
        a block; their observations come off ``total_added``, per source."""
        pref = self._prefixes(enc.sortable_key(keys))
        self._admit_prefixes(pref)
        keep = np.isin(pref, self._admitted)
        if keep.all():
            return keys, cnt
        keep_d = torch.from_numpy(keep).to(self.device)
        self._total_added -= cnt[~keep_d].sum(dim=0).cpu().numpy()
        return keys[keep_d], cnt[keep_d]

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
        with span("kmh.store.tier_merge"):
            out = merge_runs((a, b))
        self.timings["tier_merges"] += 1
        self.timings["tier_merge_rows"] += int(a[0].shape[0] + b[0].shape[0])
        self.timings["tier_merge_s"] += time.perf_counter() - t0
        return out

    def _compact_tiers(self) -> None:
        self._runs = lsm_compact(self._runs, _cap_class, self._merge_two)
        self._spill_if_needed()

    # -- host/disk spill ------------------------------------------------------
    @property
    def _row_bytes(self) -> int:
        """Bytes of one row of a run: an int64 key and int64 counters."""
        return 8 + 8 * self.counts_n

    def _device_run_bytes(self) -> int:
        return sum(int(r[0].shape[0]) for r in self._runs) * self._row_bytes

    def _spill_run(self, run: Run) -> None:
        """Move one run off the device: to host memory, or to an ``.npz``
        file under ``spill_dir`` (removed when it is read back)."""
        with span("kmh.store.spill"):
            t0 = time.perf_counter()
            keys, cnt = (self._staging.to_host(t) for t in run)
            if self.spill_dir is not None:
                os.makedirs(self.spill_dir, exist_ok=True)
                # the process id keeps two processes sharing the directory
                # apart: their stores may have the same id()
                path = os.path.join(self.spill_dir, (
                    f"kmh_spill_{os.getpid()}_{id(self):x}_"
                    f"{self._spill_seq}.npz"))
                np.savez(path, keys=keys.numpy(), cnt=cnt.numpy())
                self._spilled.append(("file", path))
            else:
                self._spilled.append(("mem", (keys, cnt)))
            n = int(keys.shape[0])
            self._spilled_rows += n
            self._spill_seq += 1
            self.timings["spills"] += 1
            self.timings["spilled_rows"] += n
            self.timings["spill_s"] += time.perf_counter() - t0

    def _spill_if_needed(self) -> None:
        """After every tier compaction: while the resident runs exceed
        ``spill_bytes`` the largest leaves. The last run may leave too (a
        flush seeds from a spilled run when none is resident)."""
        if self.spill_bytes is None:
            return
        while self._runs and self._device_run_bytes() > self.spill_bytes:
            self._runs.sort(key=lambda r: int(r[0].shape[0]))
            self._spill_run(self._runs.pop())

    def _take_spilled(self) -> Iterator[Run]:
        """Every spilled run in turn as host tensors, each file removed as
        it is read; the store has none from the first step on."""
        spilled, self._spilled = self._spilled, []
        self._spilled_rows = 0
        for tag, payload in spilled:
            if tag == "file":
                with np.load(payload) as z:
                    run = (torch.from_numpy(z["keys"]),
                           torch.from_numpy(z["cnt"]))
                os.remove(payload)
            else:
                run = payload
            yield run

    def _merge_in_fold(self, a: Run, b: Run) -> Run:
        self.timings["fold_merges"] += 1
        return merge_runs((a, b))

    def _fold_budget(self) -> int:
        """The store's ``fold_budget_bytes``, else the device's default."""
        if self.fold_budget_bytes is not None:
            return int(self.fold_budget_bytes)
        return _fold_budget_bytes(self.device)

    def _ranged_fold_needed(self, acc_rows: int) -> bool:
        """True when the plain rejoin's last merge (all rows of the table
        in, MERGE_PEAK_FACTOR times their bytes at its peak) would not fit
        the fold budget."""
        rows = acc_rows + self._spilled_rows
        return (rows * self._row_bytes * MERGE_PEAK_FACTOR
                > self._fold_budget())

    def _upload(self, keys: torch.Tensor, cnt: torch.Tensor) -> Run:
        """A host run (or slice of one) to the device, for the rejoin."""
        self.timings["rejoined_rows"] += int(keys.shape[0])
        return (self._staging.cat_to_device([keys]),
                self._staging.cat_to_device([cnt]))

    def _range_slice(self, keys: torch.Tensor, cnt: torch.Tensor) -> Run:
        """One host run's slice of a key range, on its way to the range's
        staging (host tensors in, host tensors out)."""
        self.timings["rejoined_rows"] += int(keys.shape[0])
        return keys, cnt

    def _merge_range(self, parts: List[Run]) -> Run:
        """One key range's non-empty host slices -> its piece of the table,
        in one pass: the slices' keys go up back to back into one tensor,
        B3 merges runs 2p and 2p+1 of every pair in one launch a round (an
        odd run out gets an empty partner), ceil(log2 S) rounds for S
        slices, while the host stages the count rows the same way; they
        follow the final payload in one gather, and :func:`collapse_sorted`
        sums equal keys. The first round takes the implicit payload, the
        row number in the range's buffers, and every later one carries it
        on. Device bytes at the peak, per row with one counter: 8 staged, 24
        in a round, 28 at the gather, then the collapse's; within
        MERGE_PEAK_FACTOR x 16."""
        lens = [int(p[0].shape[0]) for p in parts]
        n = sum(lens)
        keys = self._staging.cat_to_device([p[0] for p in parts])
        if len(parts) == 1:
            return keys, self._staging.cat_to_device([parts[0][1]])
        bounds = np.cumsum([0] + lens)
        pay = None
        while bounds.size > 2:
            if bounds.size % 2 == 0:  # an odd number of runs
                bounds = np.append(bounds, n)
            keys, pay = cuda_merge.merge(keys, pay, bounds)
            self.timings["range_rounds"] += 1
            bounds = bounds[::2]
        cnt = self._staging.cat_to_device([p[1] for p in parts])
        cnt = cnt.index_select(0, pay)
        del pay
        return collapse_sorted(keys, cnt)

    def _fold_spilled(self, acc: Optional[Run]) -> Run:
        """Merge the spilled runs back into the accumulator one at a time
        (on the device at any moment: the accumulator, one run and their
        merge's workspace). With no accumulator the first run seeds it."""
        if not self._spilled:
            return acc
        t0 = time.perf_counter()
        with span("kmh.store.rejoin"):
            for run in self._take_spilled():
                run = self._upload(*run)
                acc = run if acc is None else self._merge_in_fold(acc, run)
        self.timings["rejoin_s"] += time.perf_counter() - t0
        return acc

    def _fold_spilled_ranged(self) -> Run:
        """The out-of-core fold: every run is on the host (the caller
        spilled the resident ones), and the table is rebuilt by key range.
        Splitters are the keys at evenly spaced ranks of the largest run;
        range r holds the keys in [splitter r-1, splitter r), the first
        range everything below the first splitter and the last everything
        from the last splitter up. Per range the slice of every host run
        passes :meth:`_range_slice` and the range's slices merge in one
        pass (:meth:`_merge_range`); ranges are disjoint and ascending, so
        the pieces concatenate into the sorted unique table. Repeated
        splitters give empty ranges. Device bytes at the peak: the pieces
        so far, one range's pass (within the fold budget) and, at the end,
        the concatenation."""
        host_runs = list(self._take_spilled())
        total_rows = sum(int(r[0].shape[0]) for r in host_runs)
        per_range = max(1, self._fold_budget()
                        // (MERGE_PEAK_FACTOR * self._row_bytes))
        n_ranges = max(1, -(-total_rows // per_range))
        big = max(host_runs, key=lambda r: int(r[0].shape[0]))[0].numpy()
        splitters = big[[min(len(big) - 1, (i * len(big)) // n_ranges)
                         for i in range(1, n_ranges)]]
        # sortable keys: their signed order on the host is the device's
        cuts = [np.concatenate([[0], np.searchsorted(r[0].numpy(), splitters,
                                                     side="left"),
                                [r[0].shape[0]]]) for r in host_runs]
        pieces = []
        t0 = time.perf_counter()
        with span("kmh.store.rejoin"):
            for r in range(n_ranges):
                parts = []
                for (keys, cnt), cut in zip(host_runs, cuts):
                    i0, i1 = int(cut[r]), int(cut[r + 1])
                    if i1 > i0:
                        parts.append(self._range_slice(keys[i0:i1],
                                                       cnt[i0:i1]))
                if parts:
                    pieces.append(self._merge_range(parts))
        self.timings["rejoin_s"] += time.perf_counter() - t0
        self.timings["ranged_folds"] += 1
        self.timings["ranges"] += len(pieces)
        return (torch.cat([p[0] for p in pieces]),
                torch.cat([p[1] for p in pieces]))

    def flush(self) -> "CountStore":
        """Fold pending batches, all runs and all spilled runs into the
        sorted base table."""
        with span("kmh.store.fold"):
            self._build_runs()
            if not self._runs and not self._spilled:
                return self
            t0 = time.perf_counter()
            runs = self._runs + ([(self.keys, self.cnt)] if self.n_rows
                                 else [])
            self._runs = []
            if self._spilled and self._ranged_fold_needed(
                    sum(int(r[0].shape[0]) for r in runs)):
                # the rejoin goes out of core anyway: do not merge the
                # resident runs into one accumulator first (that merge is the
                # one the budget cannot hold) — every run goes to the host as
                # it is
                self.keys, self.cnt = self._empty_table()  # frees the base
                while runs:
                    self._spill_run(runs.pop())
                self.keys, self.cnt = self._fold_spilled_ranged()
            else:
                # no resident run: the first spilled one seeds it
                acc = None
                if len(runs) == 2:
                    acc = self._merge_in_fold(*runs)
                elif runs:
                    acc = runs[0] if len(runs) == 1 else merge_runs(runs)
                del runs
                self.keys, self.cnt = self._fold_spilled(acc)
            self.timings["folds"] += 1
            self.timings["fold_s"] += time.perf_counter() - t0
            self._check_budget()
            return self

    def _check_budget(self) -> None:
        """Soft memory budget like kmer_tree's max_size (kmer_tree.c:57-67):
        the estimated dense-block footprint must stay under the cap. The
        reference stops allocating blocks and silently drops their k-mers;
        this raises after the fold that first exceeds."""
        if (self.max_size_bytes is None or self.mode != "ktree"
                or self.budget_semantics == "drop"):
            return  # drop mode keeps the budget by prefix admission
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
        if self._spilled:  # their keys are on the host: fold instead
            return self.n_unique
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
        t0 = time.perf_counter()
        with span("kmh.store.spectrum_n"):
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
        self.timings["spectrum_n_s"] += time.perf_counter() - t0
        return out
