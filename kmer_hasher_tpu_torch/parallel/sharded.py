"""The sharded count store (PyTorch port of ``ShardedCountStore`` in
``kmer_hasher_tpu/parallel/sharded.py``).

Canonical k-mer counting sharded by key hash: every k-mer has one owner
shard, :func:`owner_hash` of its key, and each shard is a port
:class:`~..index.count_store.CountStore` that holds only its own keys, so
its LSM tiers merge through kernel B3 and it spills and rejoins its own
runs through the single store's code (a later rank can hold one whole).

What one batch does (:meth:`ShardedCountStore.add_reads`): the
single-device ``_fused_rp_batch`` over the whole batch (B2, canonical,
trim, no-quality rows through B1) gives one run; each key's owner is
computed; :meth:`..parallel.mesh.ShardGroup.exchange` groups the run's rows
by owner with one small readback of the D bucket sizes; each shard takes its
exact-length bucket as a run of its own. Hybrid results equal exact results
bitwise, so the flagged reads are re-counted exactly before routing.

Left out of the JAX store, with the reason:

* the per-destination capacity, its overflow flag and the doubling retry
  (``_autosize_capacity``, ``_grow_capacity``): buckets here have their
  exact lengths, so nothing can overflow; ``capacity`` is accepted, kept for
  the checkpoint's meta blob, and ignored;
* the program cache (``_LRU``, ``_program``): eager PyTorch compiles no
  program per shape;
* ``_global_put``, ``_globalize`` and ``_replicated``: one process holds
  every shard;
* the trim of dead routing slots and key-only runs: a run here is its live
  rows only, as in the port's single store;
* the allgather of every run on spill: each shard spills only its own rows.

The shards' tiers merge one shard at a time (the JAX store's ``_vmerge_*``
ran them side by side in one program).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..index import count_store as cs
from ..index.count_store import CountStore, Run
from ..ops import encode as enc
from .mesh import ShardGroup

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
    ``mesh`` (:func:`..parallel.mesh.make_mesh`): D count stores on
    ``mesh.device``, shard d holding exactly the keys whose
    :func:`owner_hash` is d.

    ``spill_bytes`` bounds the device bytes of the resident runs of all
    shards together: each shard spills its own largest run once its runs
    pass ``spill_bytes // D``, to host memory or to files under
    ``spill_dir``, and rejoins them at its fold (by key range where the
    fold budget says so). ``timings`` holds the routing's host seconds and
    what the file entries record there (reader, parse, copy);
    :meth:`shard_timings` sums the shards' own (tier merges, folds,
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
                       device=self.device)
            for _ in range(self.n_shards)]
        self._total_added = np.zeros(self.counts_n, np.int64)
        self.timings = {"routes": 0, "route_s": 0.0}

    # -- adds -----------------------------------------------------------------
    @property
    def total_added(self) -> np.ndarray:
        """Observations added per source, int64 [counts_n]."""
        return self._total_added.copy()

    def add_run(self, keys: torch.Tensor, cnt: torch.Tensor, n_obs: int,
                source: int = 0) -> "ShardedCountStore":
        """Route a run — sorted unique sortable keys [n] with int64 count
        rows [n, counts_n], as ``CountStore.add_run`` takes it — to the
        owner shards: each takes its bucket as a run of its own (still
        sorted and unique). ``n_obs`` observations of ``source`` go into
        ``total_added``."""
        if not 0 <= source < self.counts_n:
            raise ValueError("source out of range")
        if cnt.shape != (keys.shape[0], self.counts_n):
            raise ValueError("count rows do not match the keys")
        t0 = time.perf_counter()
        keys = keys.to(self.device)
        cnt = cnt.to(self.device, torch.int64)
        self._total_added[source] += int(n_obs)
        if keys.shape[0]:
            owner = owner_of_keys(keys, self.n_shards)
            buckets = self.mesh.exchange(owner, keys, cnt)
            self.timings["routes"] += 1
            self.timings["route_s"] += time.perf_counter() - t0
            for shard, (k_d, c_d) in zip(self.shards, buckets):
                if k_d.shape[0]:
                    shard.add_run(k_d, c_d, 0, source=source)
        return self

    def add_batch(self, raw: torch.Tensor, valid: torch.Tensor,
                  source: int = 0) -> "ShardedCountStore":
        """Observations of a batch — raw int64 patterns of any shape, already
        canonical, ``valid`` masking the real ones — as one run routed to
        the owner shards. (The JAX store takes them as [D, n] uint32 lanes,
        one row per device.)"""
        keys = enc.sortable_key(raw.to(self.device).reshape(-1)
                                [valid.to(self.device).reshape(-1)])
        n = int(keys.shape[0])
        if n:
            run = cs.build_run(keys, self.counts_n, source)
            self.add_run(run[0], run[1], n, source=source)
        return self

    def add_reads(self, seq, qual, lengths, has_qual, min_ll_f: float,
                  precision: str = "fast", source: int = 0,
                  with_noq: bool = False, min_q_char: Optional[int] = None,
                  n_win: Optional[int] = None) -> "ShardedCountStore":
        """One read batch ([B, L] byte planes and [B] lengths / quality
        flags on the store's device): ``counting._fused_rp_batch`` over the
        whole batch, routed to the owner shards. ``precision`` "exact"
        (f64), "fast" (f32) or "hybrid" (f32, the flagged reads re-counted
        in f64 before this returns: bitwise equal to "exact"). Rows without
        qualities go through the encoder when ``with_noq``. (The JAX
        store's ``with_q`` selected a traced branch; here rows without
        qualities emit nothing from the filter, so there is none.)"""
        from .. import counting

        run_keys, run_cnt, n_obs, flags, n_flag = counting._fused_rp_batch(
            seq, qual, lengths, has_qual, self.k, self.counts_n, source,
            float(min_ll_f), precision, with_noq, min_q_char=min_q_char,
            n_win=n_win)
        self.add_run(run_keys, run_cnt, n_obs, source=source)
        if precision == "hybrid":
            counting._sweep_backlog(
                self, [(seq, qual, lengths, flags, n_win, n_flag)], self.k,
                source, float(min_ll_f))
        return self

    def flush(self) -> "ShardedCountStore":
        """Fold every shard's runs, spilled ones included, into its base
        table (the JAX store's ``_fold``)."""
        for shard in self.shards:
            shard.flush()
        return self

    # -- sizes ----------------------------------------------------------------
    @property
    def n_unique(self) -> np.ndarray:
        """Distinct k-mers per shard, int64 [D]; folds first."""
        return np.array([s.n_unique for s in self.shards], np.int64)

    def peek_n_unique(self) -> int:
        """Exact distinct count over all shards without installing new base
        tables (the progress meter's read)."""
        return sum(s.peek_n_unique() for s in self.shards)

    def shard_timings(self) -> dict:
        """The shards' ``timings`` summed key by key."""
        out: dict = {}
        for s in self.shards:
            for key, v in s.timings.items():
                out[key] = out.get(key, 0) + v
        return out

    # -- queries --------------------------------------------------------------
    def spectrum(self, max_count: int) -> np.ndarray:
        """Global count histogram: the shards' spectra summed (each key
        lives in one shard)."""
        return np.sum([s.spectrum(max_count) for s in self.shards], axis=0)

    def spectrum_n(self, max_count: int, comb: Sequence[int],
                   comb_inner: Sequence[int],
                   source_min: Sequence[int]) -> np.ndarray:
        """Combinatorial multi-source spectrum (kmer.spec.sh.n semantics,
        src/suffix_hash.c:335-425), the shards' summed."""
        return np.sum([s.spectrum_n(max_count, comb, comb_inner, source_min)
                       for s in self.shards], axis=0)

    def lookup(self, q_raw: torch.Tensor) -> torch.Tensor:
        """Count rows for raw queries, int32 [n, counts_n] on the store's
        device, zeros for absent k-mers: the shards' lookups summed (a key
        is found in its owner shard only)."""
        q = q_raw.to(self.device).reshape(-1)
        out = torch.zeros((q.shape[0], self.counts_n), dtype=torch.int32,
                          device=self.device)
        for s in self.shards:
            out += s.lookup(q)
        return out

    # -- restore --------------------------------------------------------------
    def set_tables(self, tables: Sequence[Run]) -> "ShardedCountStore":
        """Install one base table per shard (sortable keys [n_d], int64 count
        rows [n_d, counts_n]), sorted and reduced here; the checkpoint's
        restore. Raises if a key does not belong to its shard."""
        if len(tables) != self.n_shards:
            raise ValueError(f"{len(tables)} tables for {self.n_shards} "
                             f"shards")
        for d, (shard, (keys, cnt)) in enumerate(zip(self.shards, tables)):
            keys = keys.to(self.device)
            cnt = cnt.to(self.device, torch.int64).reshape(-1, self.counts_n)
            if keys.shape[0] != cnt.shape[0]:
                raise ValueError("key lanes and count rows differ in length")
            if keys.shape[0]:
                if bool((owner_of_keys(keys, self.n_shards) != d).any()):
                    raise ValueError(f"shard {d} holds keys of another shard")
                keys, cnt = cs.reduce_rows(keys, cnt)
            shard.keys, shard.cnt = keys, cnt
        return self
