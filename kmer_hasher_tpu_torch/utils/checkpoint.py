"""Index and count-store persistence (PyTorch port of
``kmer_hasher_tpu/utils/checkpoint.py``).

The file format is the JAX package's, byte for byte in meaning: one
``.npz`` with a JSON meta blob. An index holds (magic, version, kind, k,
seq_len, n_valid) with ``s_hi`` / ``s_lo`` (uint32) and ``s_pos`` (int32)
trimmed to the live prefix; a count store holds its geometry, an optional
resume cursor, and ``u_hi`` / ``u_lo`` / ``cnt`` (uint32) with
``total_added`` (int64). A file saved by either package loads in the other.

:func:`count_store_from_numpy` carries count state across: it takes the
arrays of either package's file (or of a live JAX store) and gives a store
on the chosen device. A file of the JAX package's *sharded* store holds the
disjoint shard tables one after the other; it loads into one store here.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..index.count_store import CountStore, reduce_rows
from ..index.position_index import KmerIndex, resolve_device
from ..ops import encode as enc

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


def save_count_store(store: CountStore, path, progress=None) -> None:
    """Persist a CountStore. ``progress`` is an optional JSON-serialisable
    resume cursor (source file + reads consumed) stored in the meta blob —
    read it back with :func:`load_progress`."""
    store.flush()
    n = store.n_unique
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "count_store",
        "k": store.k, "counts_n": store.counts_n,
        "prefix_bits": store.prefix_bits, "suffix_bits": store.suffix_bits,
        "mode": store.mode, "n_unique": n,
        "max_size_bytes": store.max_size_bytes,
        "budget_semantics": store.budget_semantics,
        "admit_frozen": False,
        "progress": progress,
    }
    raw = enc.sortable_key(store.keys).cpu().numpy().view(np.uint64)
    cnt = store.cnt.cpu().numpy()
    if n and int(cnt.max()) > np.iinfo(np.uint32).max:
        raise OverflowError("a count exceeds the file format's uint32")
    np.savez_compressed(
        path, meta=json.dumps(meta),
        u_hi=(raw >> np.uint64(32)).astype(np.uint32),
        u_lo=raw.astype(np.uint32), cnt=cnt.astype(np.uint32),
        total_added=store.total_added,
    )


def count_store_from_numpy(meta: dict, u_hi, u_lo, cnt, total_added,
                           device="cuda") -> CountStore:
    """A store on ``device`` from the JAX package's arrays: uint32 ``u_hi``
    / ``u_lo`` key lanes and ``cnt`` [n, counts_n] of the live rows, and
    ``total_added``. ``meta`` gives k and counts_n and, where present,
    prefix_bits, suffix_bits, mode and max_size_bytes.

    The rows need not be sorted or distinct — the shard tables of a
    sharded store, one after the other, are neither in order nor, in
    general, free of repeats — so they are sorted and reduced here."""
    if meta.get("budget_semantics", "error") != "error":
        raise NotImplementedError(
            "budget_semantics='drop' stores are not ported yet")
    store = CountStore(
        int(meta["k"]), counts_n=int(meta["counts_n"]),
        prefix_bits=int(meta.get("prefix_bits", 0)),
        suffix_bits=meta.get("suffix_bits"), mode=meta.get("mode", "sh"),
        max_size_bytes=meta.get("max_size_bytes"), device=device)
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


def load_count_store(path, device="cuda") -> CountStore:
    """Load a saved store onto ``device``: a plain store of either package,
    or the JAX package's sharded store folded into one."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        kind = meta.get("kind")
        if meta.get("magic") != _MAGIC or kind not in (
                "count_store", "sharded_count_store"):
            raise ValueError(f"{path} is not a kmer_hasher_tpu count store")
        return count_store_from_numpy(meta, z["u_hi"], z["u_lo"], z["cnt"],
                                      z["total_added"], device=device)
