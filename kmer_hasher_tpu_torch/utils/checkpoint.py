"""Index and count-store persistence (PyTorch port of
``kmer_hasher_tpu/utils/checkpoint.py``).

The file format is the JAX package's, byte for byte in meaning: one
``.npz`` with a JSON meta blob. An index holds (magic, version, kind, k,
seq_len, n_valid) with ``s_hi`` / ``s_lo`` (uint32) and ``s_pos`` (int32)
trimmed to the live prefix; a count store holds its geometry, an optional
resume cursor, and ``u_hi`` / ``u_lo`` / ``cnt`` (uint32) with
``total_added`` (int64); a ``budget_semantics="drop"`` store adds its
``admitted`` prefixes (uint64) and the ``admit_frozen`` flag, so a resumed run
drops exactly the same prefixes. A file saved by either package loads in the
other. Saving folds the store first, spilled runs included.

:func:`count_store_from_numpy` carries count state across: it takes the
arrays of either package's file (or of a live JAX store) and gives a store
on the chosen device.

A *sharded* store (``parallel.ShardedCountStore``) is saved as the JAX
package saves its own: the shard tables one after the other in ``u_hi`` /
``u_lo`` / ``cnt``, with ``n_shards``, per-shard ``n_unique``, ``capacity``
and ``total_added``. Such a file, from either package, loads onto a shard
group of the same size (``load_count_store(path, mesh=)``), with or
without ``devices`` (each shard restored onto its own device), or folded
into one store without ``mesh``. The restored shard tables are installed
whole: no restored run is cut short.

Over a shard group that spans processes, as in the JAX package, saving is
collective: every rank folds its own shards, rank 0 gathers the D tables
and writes the file, and a barrier follows, so the file is complete when
any rank returns. Loading onto such a group reads the file on every rank
(a directory they share) and installs each rank's own shards, each on
its own device where the group spreads a rank's shards over several;
rank 0 holds the file's ``total_added``.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..index.count_store import CountStore, reduce_rows
from ..index.position_index import KmerIndex, resolve_device
from ..ops import encode as enc
from ..parallel import distributed

_MAGIC = "kmer_hasher_tpu"
_VERSION = 1


def save_index(index: KmerIndex, path) -> None:
    n = index.n_valid
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "kmer_index",
        "k": index.k, "seq_len": index.seq_len, "n_valid": n,
    }
    raw = enc.sortable_key(index.s_key[:n]).cpu().numpy()
    np.savez_compressed(
        path, meta=json.dumps(meta),
        s_hi=(raw.view(np.uint64) >> np.uint64(32)).astype(np.uint32),
        s_lo=raw.view(np.uint64).astype(np.uint32),
        s_pos=index.s_pos[:n].cpu().numpy().astype(np.int32),
    )


def index_from_numpy(k: int, seq_len: int, s_hi, s_lo, s_pos, n_valid: int,
                     device="cuda") -> KmerIndex:
    """An index on ``device`` from the JAX package's sorted arrays: uint32
    ``s_hi`` / ``s_lo`` and int32 ``s_pos``, full-axis or trimmed, of which
    the first ``n_valid`` rows are live."""
    dev = resolve_device(device)
    raw = ((np.asarray(s_hi).astype(np.uint64) << np.uint64(32))
           | np.asarray(s_lo).astype(np.uint64)).view(np.int64)
    s_key = enc.sortable_key(torch.from_numpy(raw).to(dev))
    pos = torch.from_numpy(np.asarray(s_pos).astype(np.int32)).to(dev)
    return KmerIndex.from_sorted(k, seq_len, s_key, pos, int(n_valid))


def load_index(path, device="cuda") -> KmerIndex:
    """Restore a position index without re-encoding the sequence. The
    arrays are padded to the JAX loader's power-of-two axis."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != _MAGIC or meta.get("kind") != "kmer_index":
            raise ValueError(f"{path} is not a kmer_hasher_tpu index")
        n = int(meta["n_valid"])
        cap = 1 << max(6, (n - 1).bit_length()) if n > 1 else 64
        s_hi = np.zeros(cap, np.uint32)
        s_lo = np.zeros(cap, np.uint32)
        s_pos = np.zeros(cap, np.int32)
        s_hi[:n] = z["s_hi"]
        s_lo[:n] = z["s_lo"]
        s_pos[:n] = z["s_pos"]
    return index_from_numpy(int(meta["k"]), int(meta["seq_len"]), s_hi,
                            s_lo, s_pos, n, device=device)


def _raw_from_lanes(hi, lo) -> np.ndarray:
    """uint32 (hi, lo) lanes -> raw int64 patterns."""
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).view(np.int64)


def _lanes(keys: torch.Tensor, cnt: torch.Tensor):
    """A table's sortable keys and int64 count rows as the file's uint32
    ``u_hi`` / ``u_lo`` lanes and ``cnt``."""
    raw = enc.sortable_key(keys).cpu().numpy().view(np.uint64)
    c = cnt.cpu().numpy()
    if c.size and int(c.max()) > np.iinfo(np.uint32).max:
        raise OverflowError("a count exceeds the file format's uint32")
    return ((raw >> np.uint64(32)).astype(np.uint32), raw.astype(np.uint32),
            c.astype(np.uint32))


def save_count_store(store, path, progress=None) -> None:
    """Persist a CountStore or a ShardedCountStore (the kind is recorded in
    the meta blob; :func:`load_count_store` restores either). ``progress`` is
    an optional JSON-serialisable resume cursor (source file + reads
    consumed) stored in the meta blob — read it back with
    :func:`load_progress`."""
    if hasattr(store, "mesh"):
        return _save_sharded_count_store(store, path, progress)
    store.flush()
    n = store.n_unique
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "count_store",
        "k": store.k, "counts_n": store.counts_n,
        "prefix_bits": store.prefix_bits, "suffix_bits": store.suffix_bits,
        "mode": store.mode, "n_unique": n,
        "max_size_bytes": store.max_size_bytes,
        "budget_semantics": store.budget_semantics,
        "admit_frozen": store._admit_frozen,
        "progress": progress,
    }
    extra = {}
    if store._admitted is not None:
        extra["admitted"] = store._admitted
    u_hi, u_lo, cnt = _lanes(store.keys, store.cnt)
    np.savez_compressed(
        path, meta=json.dumps(meta), u_hi=u_hi, u_lo=u_lo, cnt=cnt,
        total_added=store.total_added, **extra,
    )


def _save_sharded_count_store(store, path, progress=None) -> None:
    n = store.n_unique  # folds every shard first (gathered: a collective)
    total = store.total_added  # summed over the ranks: a collective
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "sharded_count_store",
        "k": store.k, "counts_n": store.counts_n, "n_shards": store.n_shards,
        "capacity": store.capacity, "n_unique": [int(v) for v in n],
        "progress": progress,
    }
    # each shard to the host first: over several devices they lie apart
    keys = torch.cat([s.keys.cpu() for s in store.shards])
    cnt = torch.cat([s.cnt.cpu() for s in store.shards])
    mesh = store.mesh
    if mesh.distributed:
        per = mesh.size // mesh.process_count
        rows = n.reshape(mesh.process_count, per).sum(1).tolist()
        keys_all = distributed.gather_rows(keys, rows)
        cnt_all = distributed.gather_rows(cnt, rows)
        if keys_all is not None:
            keys, cnt = torch.cat(keys_all), torch.cat(cnt_all)
    if mesh.process_index == 0:
        u_hi, u_lo, c = _lanes(keys, cnt)
        np.savez_compressed(
            path, meta=json.dumps(meta), u_hi=u_hi, u_lo=u_lo,
            cnt=c.reshape(-1, store.counts_n), total_added=total)
    mesh.barrier()


def _load_sharded_count_store(z, meta, mesh):
    """A sharded file onto the shard group ``mesh`` (of the size it was
    saved with): shard d gets rows ``n_unique[:d].sum()`` on."""
    from ..parallel.sharded import ShardedCountStore

    d_saved = int(meta["n_shards"])
    if mesh.size != d_saved:
        raise ValueError(f"store was saved with {d_saved} shards; mesh has "
                         f"{mesh.size}")
    counts_n = int(meta["counts_n"])
    store = ShardedCountStore(int(meta["k"]), mesh, counts_n=counts_n,
                              capacity=int(meta.get("capacity", 1 << 7)))
    n = np.asarray(meta["n_unique"], np.int64)
    offs = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    raw = _raw_from_lanes(z["u_hi"], z["u_lo"])
    cnt = np.asarray(z["cnt"]).reshape(-1, counts_n).astype(np.int64)
    if raw.shape[0] != offs[-1] or cnt.shape[0] != offs[-1]:
        raise ValueError("the shard tables do not match n_unique")
    store.set_tables([  # on the host: each rank uploads its own shards
        (enc.sortable_key(torch.from_numpy(raw[a:b])),
         torch.from_numpy(cnt[a:b]))
        for a, b in zip(offs[:-1], offs[1:])])
    total = np.asarray(z["total_added"], np.int64).reshape(-1)
    if total.shape[0] != counts_n:
        raise ValueError("total_added must have counts_n entries")
    store._total_added = (total.copy() if mesh.process_index == 0
                          else np.zeros_like(total))
    return store


def count_store_from_numpy(meta: dict, u_hi, u_lo, cnt, total_added,
                           device="cuda", admitted=None) -> CountStore:
    """A store on ``device`` from the JAX package's arrays: uint32 ``u_hi``
    / ``u_lo`` key lanes and ``cnt`` [n, counts_n] of the live rows, and
    ``total_added``. ``meta`` gives k and counts_n and, where present,
    prefix_bits, suffix_bits, mode, max_size_bytes, budget_semantics and
    admit_frozen; ``admitted`` is a drop store's admitted prefixes.

    The rows need not be sorted or distinct — the shard tables of a
    sharded store, one after the other, are neither in order nor, in
    general, free of repeats — so they are sorted and reduced here."""
    store = CountStore(
        int(meta["k"]), counts_n=int(meta["counts_n"]),
        prefix_bits=int(meta.get("prefix_bits", 0)),
        suffix_bits=meta.get("suffix_bits"), mode=meta.get("mode", "sh"),
        max_size_bytes=meta.get("max_size_bytes"),
        budget_semantics=meta.get("budget_semantics", "error"),
        device=device)
    if admitted is not None:
        store._admitted = np.asarray(admitted).astype(np.uint64)
        store._admit_frozen = bool(meta.get("admit_frozen", False))
    cnt = np.asarray(cnt).reshape(-1, store.counts_n).astype(np.int64)
    raw = _raw_from_lanes(u_hi, u_lo)
    if raw.shape[0] != cnt.shape[0]:
        raise ValueError("key lanes and count rows differ in length")
    total = np.asarray(total_added, np.int64).reshape(-1)
    if total.shape[0] != store.counts_n:
        raise ValueError("total_added must have counts_n entries")
    if raw.shape[0]:
        keys = enc.sortable_key(torch.from_numpy(raw).to(store.device))
        rows = torch.from_numpy(cnt).to(store.device)
        store.keys, store.cnt = reduce_rows(keys, rows)
    store._total_added = total.copy()
    return store


def load_progress(path):
    """Resume cursor stored by ``save_count_store(..., progress=)`` —
    ``{"path": ..., "reads_done": N, "done": bool}`` for counting
    checkpoints, or None for stores saved without one."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
    return meta.get("progress")


def load_count_store(path, mesh=None, device="cuda"):
    """Load a saved store of either package onto ``device``. A sharded
    store restores onto the shard group ``mesh`` (same shard count; shard d
    on ``mesh.device_of(d)``) or, with ``mesh=None``, folds into one
    CountStore. A plain store ignores ``mesh``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        kind = meta.get("kind")
        if meta.get("magic") != _MAGIC or kind not in (
                "count_store", "sharded_count_store"):
            raise ValueError(f"{path} is not a kmer_hasher_tpu count store")
        if kind == "sharded_count_store" and mesh is not None:
            return _load_sharded_count_store(z, meta, mesh)
        return count_store_from_numpy(
            meta, z["u_hi"], z["u_lo"], z["cnt"], z["total_added"],
            device=device, admitted=z["admitted"] if "admitted" in z else None)
