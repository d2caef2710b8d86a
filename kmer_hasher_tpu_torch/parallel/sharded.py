"""The sharded count store and the sharded position index (PyTorch port of
``ShardedCountStore`` and ``ShardedKmerIndex`` in
``kmer_hasher_tpu/parallel/sharded.py``).

Both shard by key hash: every k-mer has one owner shard, :func:`owner_hash`
of its key, and :meth:`..parallel.mesh.ShardGroup.exchange` routes rows to
their owners with one small readback of the D bucket sizes.

The count store: canonical k-mer counting, each shard a port
:class:`~..index.count_store.CountStore` that holds only its own keys, so
its LSM tiers merge through kernel B3 and it spills and rejoins its own
runs through the single store's code (a later rank can hold one whole).
What one batch does (:meth:`ShardedCountStore.add_reads`): the
single-device ``_fused_rp_batch`` over the whole batch (B2, canonical,
trim, no-quality rows through B1) gives one run; each key's owner is
computed; each shard takes its exact-length bucket as a run of its own.
Over a group spread over several devices the batch's rows are dealt to
the devices in contiguous blocks first, as the JAX store deals them to
chips, each device runs the pipeline on its own rows, and every bucket is
copied to its owner's device. Hybrid results equal exact results bitwise,
so the flagged reads are re-counted exactly before routing. The shards'
tiers merge one shard at a time (the JAX store's ``_vmerge_*`` ran them
side by side in one program), each on its own device.

The position index (:class:`ShardedKmerIndex`): the sequence's D chunks,
each with a (k-1)-base halo, encoded by kernel B1 in one launch a device,
every window routed to its owner and each shard sorted by (k-mer,
position) on its own device;
the tables from a copy re-sharded by sampled key ranges; queries over
every shard; :func:`iter_kmer_pairs_sharded_chunks` and
:func:`kmer_pairs_sharded` across two indexes. Over the processes of a
group each rank builds its own shards, and every table and query is a
collective that gives every rank the one-process answer.

Left out of the JAX module, with the reason:

* the per-destination capacity, its overflow flag and the doubling retry
  (``_autosize_capacity``, ``_grow_capacity``, the index build's and the
  range partition's retry loops): buckets here have their exact lengths,
  so nothing can overflow; the store's ``capacity`` is accepted, kept for
  the checkpoint's meta blob, and ignored, as is the index's
  ``capacity_factor``;
* the program cache (``_LRU``, ``_shared_program``): eager PyTorch
  compiles no program per shape;
* ``_global_put``, ``_globalize`` and ``_replicated``: a process holds
  its own shards' tensors; ``_host_read`` across processes is
  :meth:`~..parallel.mesh.ShardGroup.gather_shards` or one of the shard
  group's other host collectives;
* the trim of dead routing slots and key-only runs: a run here is its live
  rows only, as in the port's single store;
* the allgather of every run on spill: each shard spills only its own rows,
  on its own rank;
* the index's compacted expansion plans (``exp.use_plan``,
  ``ExpansionPlan``): rows expand by a plain searchsorted over prefix
  sums, in the same order.
"""
from __future__ import annotations

import time
from typing import (Dict, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..index import count_store as cs
from ..index.count_store import CountStore, Run
from ..index.position_index import (MAX_K, _NUC, _decode_kmers, _group_stats,
                                    _pair_chunk, _unique_compact, as_sequence)
from ..index.query import _hit_chunk, _pair_hit_chunk, _pair_ranges, _total
from ..ops import encode as enc
from ..ops import sort as srt
from .mesh import ShardGroup, device_blocks, to_device

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for a in [0, 2^32) held in int64: the product
    is taken in 16-bit halves of c, so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def owner_hash(hi: torch.Tensor, lo: torch.Tensor, n_shards: int,
               salt: int = 0x9E3779B1) -> torch.Tensor:
    """The JAX package's salted multiplicative hash -> owner shard in
    [0, n_shards), bit for bit (a shard's contents are part of the
    checkpoint format): uint32 arithmetic that wraps, done in int64 on the
    key's ``hi`` and ``lo`` 32-bit words (any integer tensors holding values
    in [0, 2^32)), masked to 32 bits after every multiply."""
    hi = hi.to(torch.int64) & _M32
    lo = lo.to(torch.int64) & _M32
    h = (_mul32(hi, salt) + _mul32(lo, 0x85EBCA77)) & _M32
    h = h ^ (h >> 15)
    h = _mul32(h, 0xCC9E2D51)
    h = h ^ (h >> 13)
    return h % int(n_shards)


def owner_of_keys(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owners of sortable keys (``ops.encode.sortable_key`` form)."""
    return owner_hash(*enc.split_hi_lo(enc.sortable_key(keys)), n_shards)


class ShardedCountStore:
    """Canonical k-mer counting sharded by key hash over the shard group
    ``mesh`` (:func:`..parallel.mesh.make_mesh`): D count stores, shard d
    on ``mesh.device_of(d)`` and holding exactly the keys whose
    :func:`owner_hash` is d. ``device`` is the group's home: reads come
    back there (over several devices, each shard's part computed on its
    own device first, the JAX store's ``psum``).

    Over a group that spans processes each rank holds only its own shards
    (``shards[i]`` is shard ``mesh.local_shards[i]``, on
    ``mesh.device_of`` of it, spread over the rank's own devices where the
    group names several; ``n_shards`` stays D),
    and every add routes through the group's all-to-all, also with no rows,
    so every rank must make the same adds. The reads are collectives that
    every rank makes and that give every rank the one-process store's
    answer: ``total_added`` and ``peek_n_unique`` summed, ``n_unique``
    gathered to [D], ``spectrum`` / ``spectrum_n`` / ``lookup`` summed over
    the ranks' own shards (a lookup's queries are the same on every rank).

    ``spill_bytes`` bounds the device bytes of the resident runs of all
    shards together: each shard spills its own largest run once its runs
    pass ``spill_bytes // D``, to host memory or to files under
    ``spill_dir`` (on its own rank: a shared directory holds every rank's
    files under names of their own), and rejoins them at its fold (by key
    range where the fold budget says so). ``timings`` holds the routing's
    host seconds, the exchange's seconds and the bytes it sent to other
    ranks, and what the file entries record there (reader, parse, copy);
    :meth:`shard_timings` sums this rank's shards' own (tier merges, folds,
    spills)."""

    def __init__(self, k: int, mesh: ShardGroup, counts_n: int = 1,
                 capacity: int = 1 << 7,
                 spill_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self.k = int(k)
        self.mesh = mesh
        self.n_shards = mesh.size
        self.counts_n = int(counts_n)
        self.capacity = int(capacity)
        self.device = mesh.device
        self.mode = "sh"
        self.spill_bytes = spill_bytes
        self.spill_dir = spill_dir
        per = None if spill_bytes is None else int(spill_bytes) // self.n_shards
        self.shards: List[CountStore] = [
            CountStore(self.k, counts_n=self.counts_n, mode="sh",
                       spill_bytes=per, spill_dir=spill_dir,
                       device=mesh.device_of(d))
            for d in mesh.local_shards]
        self._total_added = np.zeros(self.counts_n, np.int64)
        self.timings = {"routes": 0, "route_s": 0.0, "exchanges": 0,
                        "exchange_s": 0.0, "exchange_bytes": 0}

    # -- adds -----------------------------------------------------------------
    @property
    def total_added(self) -> np.ndarray:
        """Observations added per source, int64 [counts_n] (summed over the
        ranks: a collective)."""
        return self.mesh.all_sum(self._total_added)

    def add_run(self, keys: torch.Tensor, cnt: torch.Tensor, n_obs: int,
                source: int = 0) -> "ShardedCountStore":
        """Route a run — sorted unique sortable keys [n] with int64 count
        rows [n, counts_n], as ``CountStore.add_run`` takes it — to the
        owner shards: each takes its bucket, from each rank, as a run of its
        own (still sorted and unique). ``n_obs`` observations of ``source``
        go into ``total_added``. Over processes an empty run is routed too:
        every rank's add is one exchange. Over several devices the run
        stays where it is given, one source, and each bucket is copied to
        its owner's device."""
        if not 0 <= source < self.counts_n:
            raise ValueError("source out of range")
        if cnt.shape != (keys.shape[0], self.counts_n):
            raise ValueError("count rows do not match the keys")
        t0 = time.perf_counter()
        dev = keys.device if self.mesh.multi_device else self.device
        self._total_added[source] += int(n_obs)
        self._route([keys.to(dev)], [cnt.to(dev, torch.int64)], source, t0)
        return self

    def _route(self, keys: List[torch.Tensor], cnt: List[torch.Tensor],
               source: int, t0: float) -> None:
        """Runs, one a source (one a device over several devices), to the
        owner shards through one exchange; each shard takes its pieces in
        source order."""
        if any(k.shape[0] for k in keys) or self.mesh.distributed:
            owner = [owner_of_keys(k, self.n_shards) for k in keys]
            buckets = self.mesh.exchange(owner, keys, cnt, by_rank=True,
                                         stats=self.timings)
            self.timings["routes"] += 1
            self.timings["route_s"] += time.perf_counter() - t0
            for shard, pieces in zip(self.shards, buckets):
                for k_d, c_d in pieces:
                    if k_d.shape[0]:
                        shard.add_run(k_d, c_d, 0, source=source)

    def add_batch(self, raw: torch.Tensor, valid: torch.Tensor,
                  source: int = 0) -> "ShardedCountStore":
        """Observations of a batch — raw int64 patterns of any shape, already
        canonical, ``valid`` masking the real ones — as one run routed to
        the owner shards. (The JAX store takes them as [D, n] uint32 lanes,
        one row per device.)"""
        keys = enc.sortable_key(raw.to(self.device).reshape(-1)
                                [valid.to(self.device).reshape(-1)])
        n = int(keys.shape[0])
        if n or self.mesh.distributed:
            run = cs.build_run(keys, self.counts_n, source)
            self.add_run(run[0], run[1], n, source=source)
        return self

    def add_reads(self, seq, qual, lengths, has_qual, min_ll_f: float,
                  precision: str = "fast", source: int = 0,
                  with_noq: bool = False, min_q_char: Optional[int] = None,
                  n_win: Optional[int] = None,
                  backlog: Optional[list] = None) -> "ShardedCountStore":
        """One read batch ([B, L] byte planes and [B] lengths / quality
        flags on the store's device): ``counting._fused_rp_batch`` over the
        batch's rows, routed to the owner shards. ``precision`` "exact"
        (f64), "fast" (f32) or "hybrid" (f32, the flagged reads re-counted
        in f64 before this returns: bitwise equal to "exact"). Rows without
        qualities go through the encoder when ``with_noq``. (The JAX
        store's ``with_q`` selected a traced branch; here rows without
        qualities emit nothing from the filter, so there is none.)

        The rows are dealt to this process's M devices in contiguous
        blocks (over several devices, padded with empty rows to a multiple
        of its D/P shards first: the JAX store's rows a chip; the lockstep
        route's rank block needs no more padding, so the blocks nest, see
        ``counting._lockstep_rows``); each device runs ``_fused_rp_batch``
        on its own block, so B2 launches on every card, and the M runs go
        to one exchange. Over several devices each shard thus takes M runs
        a batch (M from every rank over processes) where a group on one
        device takes one. With ``backlog`` (a list) hybrid's flagged reads
        are appended to it, one entry a block, for the caller's sweep
        (``counting.count_batches``) instead of re-counted here."""
        from .. import counting

        if not 0 <= source < self.counts_n:
            raise ValueError("source out of range")
        t0 = time.perf_counter()
        devices = self.mesh.devices
        runs, swept = [], []
        for b, dev in zip(counting._row_blocks(
                (seq, qual, lengths, has_qual), len(self.mesh.local_shards),
                len(devices)), devices):
            b = tuple(to_device(t, dev) for t in b)
            run_keys, run_cnt, n_obs, flags, n_flag = \
                counting._fused_rp_batch(
                    *b, self.k, self.counts_n, source, float(min_ll_f),
                    precision, with_noq, min_q_char=min_q_char, n_win=n_win)
            runs.append((run_keys, run_cnt))
            swept.append((*b[:3], flags, n_win, n_flag))
            self._total_added[source] += int(n_obs)
        self._route([r[0] for r in runs], [r[1] for r in runs], source, t0)
        if precision == "hybrid":
            if backlog is not None:
                backlog.extend(swept)
            else:
                counting._sweep_backlog(self, swept, self.k, source,
                                        float(min_ll_f))
        return self

    def flush(self) -> "ShardedCountStore":
        """Fold every shard's runs, spilled ones included, into its base
        table (the JAX store's ``_fold``); this rank's shards only."""
        for shard in self.shards:
            shard.flush()
        return self

    # -- sizes ----------------------------------------------------------------
    @property
    def n_unique(self) -> np.ndarray:
        """Distinct k-mers per shard, int64 [D]; folds first (gathered over
        the ranks: a collective)."""
        local = np.array([s.n_unique for s in self.shards], np.int64)
        return self.mesh.allgather(local).reshape(-1)

    def peek_n_unique(self) -> int:
        """Exact distinct count over all shards without installing new base
        tables (the progress meter's read; summed over the ranks)."""
        return int(self.mesh.all_sum(
            [sum(s.peek_n_unique() for s in self.shards)])[0])

    def shard_timings(self) -> dict:
        """This rank's shards' ``timings`` summed key by key."""
        out: dict = {}
        for s in self.shards:
            for key, v in s.timings.items():
                out[key] = out.get(key, 0) + v
        return out

    # -- queries --------------------------------------------------------------
    def _summed(self, parts: List[np.ndarray]) -> np.ndarray:
        """This rank's shards' histograms summed, then over the ranks (in
        int64: they hold whole counts), in their own dtype."""
        local = np.sum(parts, axis=0)
        if not self.mesh.distributed:
            return local
        total = self.mesh.all_sum(local.astype(np.int64).reshape(-1))
        return total.reshape(local.shape).astype(local.dtype)

    def spectrum(self, max_count: int) -> np.ndarray:
        """Global count histogram: the shards' spectra summed (each key
        lives in one shard)."""
        return self._summed([s.spectrum(max_count) for s in self.shards])

    def spectrum_n(self, max_count: int, comb: Sequence[int],
                   comb_inner: Sequence[int],
                   source_min: Sequence[int]) -> np.ndarray:
        """Combinatorial multi-source spectrum (kmer.spec.sh.n semantics,
        src/suffix_hash.c:335-425), the shards' summed."""
        return self._summed([s.spectrum_n(max_count, comb, comb_inner,
                                          source_min) for s in self.shards])

    def lookup(self, q_raw: torch.Tensor) -> torch.Tensor:
        """Count rows for raw queries, int32 [n, counts_n] on the store's
        device, zeros for absent k-mers: the shards' lookups summed (a key
        is found in its owner shard only), on each device and then on the
        home device, then over the ranks."""
        q = q_raw.to(self.device).reshape(-1)
        out = torch.zeros((q.shape[0], self.counts_n), dtype=torch.int32,
                          device=self.device)
        for dev, mine in device_blocks(self.mesh):
            q_d = to_device(q, dev)
            part = self.shards[mine[0]].lookup(q_d)
            for i in mine[1:]:
                part += self.shards[i].lookup(q_d)
            out += to_device(part, self.device)
        if self.mesh.distributed:
            summed = self.mesh.all_sum(out.cpu().numpy().reshape(-1))
            out = torch.from_numpy(summed.reshape(tuple(out.shape))).to(
                self.device, torch.int32)
        return out

    # -- restore --------------------------------------------------------------
    def set_tables(self, tables: Sequence[Run]) -> "ShardedCountStore":
        """Install the base tables of all D shards (sortable keys [n_d],
        int64 count rows [n_d, counts_n], on any device), sorted and reduced
        here; the checkpoint's restore. A rank installs its own shards',
        each on its own device. Raises if a key does not belong to its
        shard."""
        if len(tables) != self.n_shards:
            raise ValueError(f"{len(tables)} tables for {self.n_shards} "
                             f"shards")
        for shard, d in zip(self.shards, self.mesh.local_shards):
            keys, cnt = tables[d]
            dev = self.mesh.device_of(d)
            keys = keys.to(dev)
            cnt = cnt.to(dev, torch.int64).reshape(-1, self.counts_n)
            if keys.shape[0] != cnt.shape[0]:
                raise ValueError("key lanes and count rows differ in length")
            if keys.shape[0]:
                if bool((owner_of_keys(keys, self.n_shards) != d).any()):
                    raise ValueError(f"shard {d} holds keys of another shard")
                keys, cnt = cs.reduce_rows(keys, cnt)
            shard.keys, shard.cnt = keys, cnt
        return self


# -- the sharded position index ----------------------------------------------

SAMPLES = 64  # splitter samples a shard takes (the JAX package's S)
_LAST = (-1) ^ enc.SIGN  # the sortable form of the raw all-ones pattern


class Shard(NamedTuple):
    """One shard of a sharded index: sortable keys and int32 1-based
    positions in (key, position) order, every row live (so ``n_valid`` is
    the length; the single index's query helpers take a shard as they
    take a :class:`~..index.position_index.KmerIndex`)."""
    s_key: torch.Tensor
    s_pos: torch.Tensor

    @property
    def n_valid(self) -> int:
        return int(self.s_key.shape[0])


class _Groups(NamedTuple):
    """The segment statistics of one range shard: each k-mer's count, the
    global 1-based k-mer rank of every row, the rows' remaining-pair run
    lengths and their prefix sum, the segment starts, the number of
    distinct k-mers and of pairs."""
    counts: torch.Tensor
    i_col: torch.Tensor
    m: torch.Tensor
    cum_m: torch.Tensor
    starts: torch.Tensor
    n_unique: int
    n_pairs: int


def chunk_rows(seq: torch.Tensor, n_shards: int, chunk: int, k: int,
               device, shards: Optional[range] = None
               ) -> Tuple[torch.Tensor, np.ndarray]:
    """The sharded build's batch for B1: the row of shard d holds chunk d of
    the uint8 sequence ``seq`` padded with N to ``n_shards * chunk`` bases,
    then the max(1, k-1) bases after it (its right neighbour's first bases,
    read from ``seq`` whichever rank owns that neighbour; N past the last
    chunk), [len(shards), chunk + halo] on ``device``, for the shards in
    ``shards`` (all of them by default; a rank passes its own); and each
    row's length on the host, int32: min(len - d * chunk, chunk + halo),
    zero or less for chunks past the end. Only the rows' bases go to the
    device."""
    shards = range(n_shards) if shards is None else shards
    halo = max(1, k - 1)
    L = int(seq.shape[0])
    first = shards.start * chunk
    x = torch.full((len(shards) * chunk + halo,), ord("N"), dtype=torch.uint8,
                   device=device)
    part = seq[first: first + x.shape[0]]
    x[:part.shape[0]] = part
    d = np.arange(shards.start, shards.stop, dtype=np.int64)
    lengths = np.minimum(L - d * chunk, chunk + halo).astype(np.int32)
    return x.unfold(0, chunk + halo, chunk).contiguous(), lengths


def _sort_shard(raw: torch.Tensor, pos: torch.Tensor, k: int) -> Shard:
    """A shard from routed live rows (raw keys, global positions)."""
    valid = torch.ones(raw.shape, dtype=torch.bool, device=raw.device)
    return Shard(*srt.sort_windows(raw, valid, k, pos=pos))


def _same_group(a: ShardGroup, b: ShardGroup) -> bool:
    """Two groups are the same where they lay out as many shards the same
    way on the same devices and over the same processes, this rank owning
    the same shards in both (the JAX package compares meshes by their
    devices)."""
    def layout(g: ShardGroup):
        return (g.size, g.shape, g.device, g.devices, g.process_count,
                g.process_index)
    return a is b or layout(a) == layout(b)


def _row_keys(rows: torch.Tensor) -> torch.Tensor:
    """(i, j) rows -> int64 keys in (i, j) order."""
    return (rows[:, 0].to(torch.int64) << 32) | rows[:, 1].to(torch.int64)


def _empty_rows(dev: torch.device) -> torch.Tensor:
    return torch.zeros((0, 2), dtype=torch.int32, device=dev)


class ShardedKmerIndex:
    """Position index over one sequence, sharded by k-mer hash over the
    shard group ``mesh`` (PyTorch port of ``ShardedKmerIndex`` in
    ``kmer_hasher_tpu/parallel/sharded.py``).

    Build: the sequence is cut into D chunks of ``chunk`` bases (the next
    power of two, at least 16, above len / D; padded with N); the chunks,
    each with the first max(1, k-1) bases of its right neighbour as a
    halo, form one [D, chunk + halo] batch that kernel B1 encodes in one
    launch, each row up to its own length (zero or less for chunks past the
    end). A window is kept where it starts in its own chunk, is valid, and
    is not the trailing-exact-k quirk's. Every window goes to the shard
    :func:`owner_hash` of its raw key names
    (:meth:`~..parallel.mesh.ShardGroup.exchange`), where the rows are
    sorted by (k-mer, position). ``shards[i]`` is shard
    ``mesh.local_shards[i]`` at its exact length on its device
    (``mesh.device_of``); ``n_valid`` the lengths of all D shards (int64
    [D]). Nothing is padded to a capacity: ``capacity_factor`` is accepted
    and ignored.

    Tables (``kmer_strings``, ``counts``, ``pos_table``, the pair stream)
    come from a second copy re-sharded by key range
    (:meth:`_range_partitioned`), emitted shard by shard in key order:
    they equal the single index's. Queries search every hash shard.
    Tensors come back on the group's (home) device.

    Over a group spread over several devices each device encodes its own
    shards' rows of the batch in one B1 launch, the routed windows are
    copied to their owners' devices and every shard is sorted there; each
    range shard lives on the device of its hash shard's number. Queries
    are copied to every device, and what the shards give back is summed or
    merged on the home device.

    Over a group that spans processes every rank holds the whole host
    sequence, as in the JAX package, and encodes, routes and sorts only its
    own shards: its rows of the batch (each with its halo, whichever rank
    owns the neighbour chunk) in one B1 launch, also where they all lie
    past the end; positions stay global. Every read is then a collective
    that gives every rank the one-process answer: the splitters from the
    shards' samples gathered to every rank, the range shards' sizes and
    k-mer rank bases from one allgather, every table gathered in shard
    order, the pair stream chunk by chunk from the rank owning its shard,
    lookups summed, and every query stream round by round, each round's
    chunks gathered to every rank, so that every rank merges the same
    streams. Where the group also spreads each rank's shards over its
    devices, each device encodes its own rows and every device of every
    rank is one source of the exchange. The number of rounds follows from
    allgathered totals, so the
    ranks stay in step as long as every rank makes the same calls in the
    same order, which it must. ``timings`` holds the routes and their
    seconds, the exchange's seconds and the bytes it sent to other ranks,
    and the gathers' seconds and the bytes this rank received.
    """

    def __init__(self, seq, k: int, mesh: ShardGroup,
                 capacity_factor: float = 2.0,
                 drop_trailing_exact_k: bool = True):
        if not 1 <= k <= MAX_K:
            raise ValueError("k must be in 1..32")
        seq = as_sequence(seq)
        if seq.shape[0] <= k:
            raise ValueError("the length of the sequence must be at least k")
        self.k = int(k)
        self.mesh = mesh
        self.n_shards = D = mesh.size
        self.device = mesh.device
        L = self.seq_len = int(seq.shape[0])
        # the reference drops the final window when its region starts fresh
        # (src/kmer_pos.c:81-84): the one position it can hit
        quirk = -1
        if drop_trailing_exact_k:
            a = L - k
            if a == 0 or (seq[a - 1] | 0x20) == ord("n"):
                quirk = a + 1
        self._quirk_pos = quirk
        self.chunk = 1 << max(4, (-(-L // D) - 1).bit_length())
        self.timings = {"routes": 0, "route_s": 0.0, "exchanges": 0,
                        "exchange_s": 0.0, "exchange_bytes": 0, "gathers": 0,
                        "gather_s": 0.0, "gather_bytes": 0}
        self.shards = self._build(seq)
        self.n_valid = mesh.allgather([s.n_valid for s in self.shards]
                                      ).reshape(-1)
        self.total_kmers = int(self.n_valid.sum())
        self.drop_range_partition()

    def _build(self, seq: np.ndarray) -> List[Shard]:
        k, D, Lc = self.k, self.n_shards, self.chunk
        owner, raws, poss = [], [], []
        for i, dev in enumerate(self.mesh.devices):  # one source a device
            mine = self.mesh.shards_on(i)
            rows, lengths = chunk_rows(torch.from_numpy(seq), D, Lc, k, dev,
                                       mine)
            raw, valid = enc.encode_stream(rows, k, lengths, canonical=False,
                                           drop_trailing_exact_k=False)
            pos = torch.arange(mine.start * Lc + 1, mine.stop * Lc + 1,
                               dtype=torch.int32,
                               device=dev).view(len(mine), Lc)
            # windows that start in their own chunk, and not the quirk's
            live = valid[:, :Lc] & (pos != self._quirk_pos)
            raw, pos = raw[:, :Lc][live], pos[live]
            owner.append(owner_hash(*enc.split_hi_lo(raw), D))
            raws.append(raw)
            poss.append(pos)
        return [_sort_shard(r, p, k)
                for r, p in self._route(owner, raws, poss)]

    def _route(self, owner: torch.Tensor, *cols: torch.Tensor) -> list:
        """The group's exchange, timed into ``timings``."""
        t0 = time.perf_counter()
        out = self.mesh.exchange(owner, *cols, stats=self.timings)
        self.timings["routes"] += 1
        self.timings["route_s"] += time.perf_counter() - t0
        return out

    def _gather(self, local: Sequence[torch.Tensor], rows) -> List[torch.Tensor]:
        """All D shards' tensors from this rank's (``rows`` their D
        lengths, known to every rank) on the home device, gathers timed
        into ``timings``."""
        return self.mesh.gather_shards(local, rows, stats=self.timings)

    def _per_shard(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on each of this rank's shards' devices (one copy a
        device), in shard order."""
        out = []
        for dev, mine in device_blocks(self.mesh):
            out.extend([to_device(t, dev)] * len(mine))
        return out

    # -- the key-range copy ---------------------------------------------------
    def _splitters(self) -> torch.Tensor:
        """D-1 sortable keys cutting the key space into D ranges: S keys
        sampled from each hash shard at ``(arange(S) * n) // S``, pooled
        from every rank and sorted, then keys[(i+1) * len // D]. An empty
        shard gives S copies of the all-ones key (the JAX package reads its
        shard's invalid tail there: the all-ones key too for k > 16, raw
        0xFFFFFFFF for k <= 16, its packed form); the tables are the same
        either way, as range shards are emitted in key order."""
        D, dev = self.n_shards, self.device
        idx = torch.arange(SAMPLES, dtype=torch.int64, device=dev)
        samples = [s.s_key[i * s.n_valid // SAMPLES] if s.n_valid
                   else torch.full((SAMPLES,), _LAST, dtype=torch.int64,
                                   device=i.device)
                   for s, i in zip(self.shards, self._per_shard(idx))]
        keys = torch.sort(torch.cat(self._gather(samples,
                                                 [SAMPLES] * D))).values
        n = keys.shape[0]
        return keys[torch.tensor([(i + 1) * n // D for i in range(D - 1)],
                                 dtype=torch.int64, device=dev)]

    def _range_partitioned(self, splitters: Optional[torch.Tensor] = None
                           ) -> List[Shard]:
        """This rank's shards of the index re-sharded by key range, so that
        emitting the shards in order is emitting in key order: row r goes to
        the shard ``searchsorted(splitters, key, right)`` names, so every
        copy of a key lands in one shard. Cached, with its splitters in
        ``_rp_spl``. ``splitters`` (sortable keys [D-1]) partitions into
        another index's intervals (:func:`iter_kmer_pairs_sharded_chunks`)
        and is not cached."""
        if splitters is None and self._rp is not None:
            return self._rp
        spl = self._splitters() if splitters is None else splitters
        owner, keys, pos = [], [], []
        for dev, mine in device_blocks(self.mesh):  # one source a device
            keys.append(torch.cat([self.shards[i].s_key for i in mine]))
            pos.append(torch.cat([self.shards[i].s_pos for i in mine]))
            owner.append(torch.searchsorted(to_device(spl, dev), keys[-1],
                                            right=True))
        rp = [_sort_shard(enc.sortable_key(r), p, self.k)
              for r, p in self._route(owner, keys, pos)]
        if splitters is None:
            self._rp, self._rp_spl = rp, spl
        return rp

    def drop_range_partition(self) -> None:
        """Release the key-range copy and its statistics (a second copy of
        the index on the device while tables are read); the next table
        call rebuilds it."""
        self._rp: Optional[List[Shard]] = None
        self._rp_spl: Optional[torch.Tensor] = None
        self._rp_stats: Optional[List[_Groups]] = None
        self._rp_sizes: Optional[np.ndarray] = None

    def _rp_group_stats(self) -> List[_Groups]:
        """This rank's range shards' segment statistics (cached), the k-mer
        ranks made global by the distinct counts of the shards before it.
        Fills ``_rp_sizes``, int64 [D, 3]: every range shard's rows,
        distinct k-mers and pairs, from one allgather."""
        if self._rp_stats is None:
            rp, local = self._range_partitioned(), []
            for s in rp:
                n = s.n_valid
                starts = srt.segment_starts(s.s_key, torch.ones_like(
                    s.s_key, dtype=torch.bool))
                counts, i_col, _rank, m, cum_m = _group_stats(
                    s.s_pos, n, starts, srt.segment_ids(starts))
                n_u = int(starts.sum())
                local.append(_Groups(counts[:n_u], i_col, m, cum_m, starts,
                                     n_u, int(cum_m[-1]) if n else 0))
            sizes = self.mesh.allgather([
                v for s, g in zip(rp, local)
                for v in (s.n_valid, g.n_unique, g.n_pairs)]).reshape(-1, 3)
            base = np.concatenate([[0], np.cumsum(sizes[:, 1])])
            self._rp_sizes = sizes
            self._rp_stats = [g._replace(i_col=g.i_col + int(base[d]))
                              for d, g in zip(self.mesh.local_shards, local)]
        return self._rp_stats

    # -- kmer.pos table family (src/kmer_hash.c:1054-1147) ------------------
    @property
    def n_kmers(self) -> int:
        self._rp_group_stats()
        return int(self._rp_sizes[:, 1].sum())

    @property
    def total_pairs(self) -> int:
        self._rp_group_stats()
        return int(self._rp_sizes[:, 2].sum())

    def kmer_strings(self) -> List[str]:
        """The distinct k-mers decoded, in key order."""
        stats = self._rp_group_stats()
        u_key = torch.cat(self._gather(
            [_unique_compact(s.s_key, g.starts)
             for s, g in zip(self._range_partitioned(), stats)],
            self._rp_sizes[:, 1]))
        chars = _NUC[_decode_kmers(u_key, self.k).cpu().numpy()]
        return [bytes(row).decode("ascii") for row in chars]

    def counts(self) -> torch.Tensor:
        """int32 occurrence count of each distinct k-mer, in key order."""
        stats = self._rp_group_stats()
        return torch.cat(self._gather([g.counts for g in stats],
                                      self._rp_sizes[:, 1]))

    def pos_table(self) -> torch.Tensor:
        """[total_kmers, 2] int32 (i, pos): i the global 1-based k-mer
        rank, pos the 1-based window start; the single index's table."""
        stats = self._rp_group_stats()
        return torch.cat(self._gather(
            [torch.stack([g.i_col, s.s_pos], dim=1)
             for s, g in zip(self._range_partitioned(), stats)],
            self._rp_sizes[:, 0]))

    def iter_pair_chunks(self, capacity: int = 1 << 20
                         ) -> Iterator[torch.Tensor]:
        """Stream the (i, x, y) pair table range shard by range shard, in
        chunks of at most ``capacity`` rows (clamped to each shard's
        total): concatenated, the single index's pair table. Each chunk
        comes from the rank that owns its shard."""
        stats = self._rp_group_stats()
        rp, mine = self._range_partitioned(), self.mesh.local_shards
        none = torch.zeros((0, 3), dtype=torch.int32, device=self.device)
        for d, n_pairs in enumerate(self._rp_sizes[:, 2].tolist()):
            cap = srt.clamp_chunk_capacity(capacity, n_pairs)
            for start in range(0, n_pairs, cap):
                rows = np.zeros(self.n_shards, np.int64)
                rows[d] = n = min(cap, n_pairs - start)
                yield self._gather([
                    _pair_chunk(s.s_pos, g.i_col, g.m, g.cum_m, s.n_valid,
                                start, n) if e == d else none
                    for e, s, g in zip(mine, rp, stats)], rows)[d]

    def tables(self, opt_flag: int, max_pairs: Optional[int] = None
               ) -> Dict:
        """The ``kmer.pos`` entry (opt_flag bits 1=kmer 2=pos 4=pair.pos
        8=count, src/kmer_hash.c:17), from the sharded index."""
        out = {"kmer": None, "pos": None, "pair.pos": None, "count": None}
        if opt_flag & 1:
            out["kmer"] = self.kmer_strings()
        if opt_flag & 2:
            out["pos"] = self.pos_table()
        if opt_flag & 4:
            total = self.total_pairs
            if max_pairs is not None and total > max_pairs:
                raise MemoryError(
                    f"pair table has {total} rows > max_pairs={max_pairs}; "
                    "use iter_pair_chunks() to stream")
            chunks = list(self.iter_pair_chunks())
            out["pair.pos"] = (torch.cat(chunks) if chunks else torch.zeros(
                (0, 3), dtype=torch.int32, device=self.device))
        if opt_flag & 8:
            out["count"] = self.counts()
        return out

    # -- queries --------------------------------------------------------------
    def _queries(self, q_raw) -> torch.Tensor:
        """Raw int64 k-mer patterns (as ``ops.encode.encode_stream`` gives
        them) -> flat sortable keys on the group's device."""
        q = torch.as_tensor(q_raw).to(self.device, torch.int64)
        return enc.sortable_key(q.reshape(-1))

    def _bounds(self, q: torch.Tensor):
        """This rank's shards' (lb, ub) rows of sortable queries, each on
        its shard's device."""
        return [srt.lookup_bounds(s.s_key, s.n_valid, q_d)
                for s, q_d in zip(self.shards, self._per_shard(q))]

    def lookup_counts(self, q_raw) -> torch.Tensor:
        """int32 occurrence count of each queried k-mer: the shards' counts
        summed (a key lives in one shard), then over the ranks. Queries are
        raw int64 patterns, as the port's ``CountStore.lookup`` takes them
        (the JAX package takes their (hi, lo) uint32 halves)."""
        q = self._queries(q_raw)
        out = torch.zeros(q.shape, dtype=torch.int64, device=self.device)
        for lb, ub in self._bounds(q):
            out += to_device(ub - lb, self.device)
        if self.mesh.distributed:
            out = torch.from_numpy(self.mesh.all_sum(out.cpu().numpy())).to(
                self.device)
        return out.to(torch.int32)

    def _hit_totals(self, ranges) -> np.ndarray:
        """Every shard's hit total, int64 [D], from this rank's shards'
        (lb, c, cum_c)."""
        return self.mesh.allgather([_total(r[2]) for r in ranges]
                                   ).reshape(-1)

    def _round(self, call, starts: np.ndarray, counts: np.ndarray,
               none: torch.Tensor) -> List[torch.Tensor]:
        """One round of the per-shard chunk streams: shard d's ``counts[d]``
        rows from ``starts[d]`` (``call(i, start, n)`` for this rank's i-th
        shard; ``none`` where a shard has no rows this round), gathered in
        shard order on every rank."""
        return self._gather([
            call(i, int(starts[d]), int(counts[d])) if counts[d] else none
            for i, d in enumerate(self.mesh.local_shards)], counts)

    def _drain_chunks(self, call, C: int, totals: np.ndarray,
                      none: torch.Tensor) -> List[torch.Tensor]:
        """Run a per-shard chunk emitter until every shard's true total is
        drained, C rows a shard a round (no truncation), in the order
        round by round, shard by shard."""
        chunks = []
        for start in range(0, int(totals.max(initial=0)), C):
            counts = np.clip(totals - start, 0, C)
            got = self._round(call, np.full_like(totals, start), counts, none)
            chunks.extend(c for c, n in zip(got, counts) if n)
        return chunks

    def positions_of(self, q_raw, max_hits_per_shard: int = 1 << 16
                     ) -> torch.Tensor:
        """Every 1-based position of the queried k-mers (raw int64
        patterns), ascending, int32: gathered from every shard in chunks of
        at most ``max_hits_per_shard`` rows, never truncated."""
        q = self._queries(q_raw)
        ranges = []
        for lb, ub in self._bounds(q):
            c = ub - lb
            ranges.append((lb, c, torch.cumsum(c, dim=0)))
        totals = self._hit_totals(ranges)
        C = srt.clamp_chunk_capacity(max_hits_per_shard,
                                     int(totals.max(initial=0)))
        none = torch.zeros(0, dtype=torch.int32, device=self.device)
        chunks = self._drain_chunks(lambda i, start, n: _hit_chunk(
            self.shards[i].s_pos, *ranges[i], self.k, start, n)[:, 1],
            C, totals, none)
        if not chunks:
            return none
        return torch.sort(torch.cat(chunks)).values

    def seq_kmer_pos(self, query, k: int,
                     max_hits_per_shard: int = 1 << 20) -> torch.Tensor:
        """Sharded ``seq.kmer.pos``: the full (i, j) int32 matrix in the
        reference's row order (see :meth:`iter_seq_kmer_pos`)."""
        blocks = list(self.iter_seq_kmer_pos(query, k, max_hits_per_shard))
        return torch.cat(blocks) if blocks else _empty_rows(self.device)

    def iter_seq_kmer_pos(self, query, k: int,
                          max_hits_per_shard: int = 1 << 20
                          ) -> Iterator[torch.Tensor]:
        """Stream sharded ``seq.kmer.pos`` rows as (i, j)-sorted int32
        blocks on the group's device, as the single index's
        ``iter_seq_kmer_pos_chunks`` yields its chunks (no block where
        nothing hits): i the 1-based query position of the window's last
        base, j the 1-based start in the index. The query is encoded once
        (B1, padded with N to a power of two, at least 64); every shard
        emits the rows of the k-mers it owns in chunks of at most
        ``max_hits_per_shard``, already (i, j)-sorted, and no window hits
        two shards, so a frontier-bounded merge (:meth:`_merge_sorted_streams`)
        yields the rows in global order."""
        query = as_sequence(query, "query")
        if query.shape[-1] <= k or k > 31:
            raise ValueError(
                "the sequence should be longer than k and k should not be"
                " longer than 31")
        tl = int(query.shape[0])
        x = torch.full((1 << max(6, (tl - 1).bit_length()),), ord("N"),
                       dtype=torch.uint8, device=self.device)
        x[:tl] = torch.from_numpy(query)
        key, valid = enc.encode_stream(x, k, tl, drop_trailing_exact_k=True)
        ranges = []
        for (lb, ub), v in zip(self._bounds(enc.sortable_key(key)),
                               self._per_shard(valid)):
            c = torch.where(v, ub - lb, 0)
            ranges.append((lb, c, torch.cumsum(c, dim=0)))
        totals = self._hit_totals(ranges)
        C = srt.clamp_chunk_capacity(max_hits_per_shard,
                                     int(totals.max(initial=0)))
        yield from self._merge_sorted_streams(
            lambda i, start, n: _hit_chunk(self.shards[i].s_pos, *ranges[i],
                                           k, start, n), C, totals)

    def _merge_sorted_streams(self, call, C: int, totals: np.ndarray
                              ) -> Iterator[torch.Tensor]:
        """Drain per-shard chunk streams (``call(i, start, n)`` for this
        rank's i-th shard: each stream (i, j)-sorted, the streams disjoint
        in i) and yield globally sorted blocks as soon as they are safe: a
        buffered row goes out once every shard still drawing has drained
        past it. Every rank buffers every shard's rows (each round's chunks
        gathered to all), so every rank decides alike.

        Buffers stay bounded under skew: a shard stops drawing while it
        buffers 2*C rows, so the peak (``_merge_peak_rows``) is at most
        3*D*C rows. The frontier shard's buffered rows all lie at or below
        its own last drained key, so each emission empties it and it draws
        again."""
        D, dev = self.n_shards, self.device
        bufs = [_empty_rows(dev) for _ in range(D)]
        cursors = np.zeros(D, np.int64)
        last_key = np.full(D, -1, np.int64)  # last drained key a shard
        self._merge_peak_rows = 0
        while True:
            willing = (cursors < totals) & np.array(
                [b.shape[0] < 2 * C for b in bufs])
            if willing.any():
                counts = np.where(willing, np.minimum(C, totals - cursors), 0)
                got = self._round(call, cursors, counts, _empty_rows(dev))
                for d in np.flatnonzero(willing).tolist():
                    bufs[d] = torch.cat([bufs[d], got[d]])
                    last_key[d] = int(_row_keys(got[d][-1:])[0])
            cursors = np.where(willing, cursors + C, cursors)
            unfinished = cursors < totals
            self._merge_peak_rows = max(
                self._merge_peak_rows, sum(b.shape[0] for b in bufs))
            done = not unfinished.any()
            frontier = None if done else torch.tensor(
                [int(last_key[unfinished].min())], device=dev)
            out = []
            for d in range(D):
                if not bufs[d].shape[0]:
                    continue
                cut = bufs[d].shape[0] if done else int(torch.searchsorted(
                    _row_keys(bufs[d]), frontier, right=True))
                if cut:
                    out.append(bufs[d][:cut])
                    bufs[d] = bufs[d][cut:]
            if out:
                block = torch.cat(out)
                yield block[torch.argsort(_row_keys(block), stable=True)]
            if done:
                return


#: peak rows buffered by the last drain of iter_kmer_pairs_sharded_chunks
#: (a test's handle on its bounded memory)
_PAIRS_STREAM_STATS = {"peak_rows": 0}


def iter_kmer_pairs_sharded_chunks(a: ShardedKmerIndex, b: ShardedKmerIndex,
                                   capacity: int = 1 << 20
                                   ) -> Iterator[torch.Tensor]:
    """Stream ``kmer.pairs`` across two sharded indexes as (a_pos, b_pos)
    int32 blocks on the group's device, in the single index's row order
    (the multi-shard form of ``index.query.iter_kmer_pairs_chunks``).

    Both indexes are re-sharded by key range with ``a``'s splitters, so
    shard d owns the same key interval in both; each shard emits its
    cross-products in a-sorted order in chunks of at most ``capacity``
    rows, and emitting shard by shard is the single index's order, with no
    sort. A shard ahead of the one being emitted stops drawing once it
    buffers 2 chunks, so at most about 3*D*capacity rows are held. With no
    rows at all, one empty (0, 2) block. Over processes the shard totals
    are allgathered and each round's chunks gathered to every rank, so
    every rank yields the same blocks."""
    if not _same_group(a.mesh, b.mesh):
        raise ValueError("both indexes must live on the same mesh")
    if a.k != b.k:
        raise ValueError("k mismatch between indexes")
    D = a.n_shards
    ra = a._range_partitioned()
    rb = b._range_partitioned(splitters=a._rp_spl)
    ranges = [_pair_ranges(x, y) for x, y in zip(ra, rb)]
    totals = a._hit_totals(ranges)
    C = srt.clamp_chunk_capacity(capacity, int(totals.max(initial=0)))
    bufs: List[List[torch.Tensor]] = [[] for _ in range(D)]
    buffered = np.zeros(D, np.int64)
    cursors = np.zeros(D, np.int64)
    emit_d = 0  # the shard being emitted
    _PAIRS_STREAM_STATS["peak_rows"] = 0
    if not totals.any():
        yield _empty_rows(a.device)
        return
    while emit_d < D:
        # the shard being emitted always draws (its buffer empties below);
        # shards ahead stall at 2 chunks
        willing = (cursors < totals) & (buffered < 2 * C)
        if willing.any():
            counts = np.where(willing, np.minimum(C, totals - cursors), 0)
            got = a._round(lambda i, start, n: _pair_hit_chunk(
                ra[i].s_pos, rb[i].s_pos, *ranges[i], start, n), cursors,
                counts, _empty_rows(a.device))
            for d in np.flatnonzero(willing).tolist():
                bufs[d].append(got[d])
                buffered[d] += counts[d]
        cursors = np.where(willing, cursors + C, cursors)
        _PAIRS_STREAM_STATS["peak_rows"] = max(
            _PAIRS_STREAM_STATS["peak_rows"], int(buffered.sum()))
        while emit_d < D:
            while bufs[emit_d]:
                blk = bufs[emit_d].pop(0)
                buffered[emit_d] -= blk.shape[0]
                yield blk
            if cursors[emit_d] < totals[emit_d]:
                break
            emit_d += 1


def kmer_pairs_sharded(a: ShardedKmerIndex, b: ShardedKmerIndex,
                       capacity: int = 1 << 20,
                       max_pairs: Optional[int] = None) -> torch.Tensor:
    """Eager ``kmer.pairs`` across two sharded indexes, collected from
    :func:`iter_kmer_pairs_sharded_chunks`. Past ``max_pairs`` rows it
    raises MemoryError (stream past the blow-up with the iterator); over
    processes every rank raises at the same block."""
    blocks, total = [], 0
    for blk in iter_kmer_pairs_sharded_chunks(a, b, capacity):
        total += blk.shape[0]
        if max_pairs is not None and total > max_pairs:
            raise MemoryError(
                f"kmer.pairs has > max_pairs={max_pairs} rows; stream "
                "them with iter_kmer_pairs_sharded_chunks instead")
        blocks.append(blk)
    return torch.cat(blocks)
