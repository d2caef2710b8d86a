"""The multi-device dry run (PyTorch twin of ``dryrun_multichip`` in the
JAX package's ``__graft_entry__.py``): the sharded index build, a
replicated lookup and counting batches routed to their key shards, on a
shard group spread over the given devices::

    from kmer_hasher_tpu_torch.multichip import dryrun_multichip
    dryrun_multichip(8, devices=["cuda:0", "cuda:1"])   # 4 shards a card
    dryrun_multichip(8, device="cpu", devices=["cpu"] * 8)
"""
from __future__ import annotations

import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from .ops import encode as enc
from .parallel import (ShardedCountStore, ShardedKmerIndex,
                       kmer_pairs_sharded, make_hierarchical_mesh, make_mesh)
from .utils import checkpoint as ckpt


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda",
                     devices: Optional[Sequence] = None) -> dict:
    """The JAX function's steps on ``n_devices`` shards spread over
    ``devices`` (all on ``device`` when None), with its draws from seed 1:

    1. ``ShardedKmerIndex`` of 4,096 random bases at k = 16 (each device
       encodes its own chunks, every window routed to its owner);
    2. ``lookup_counts`` of the windows of its first 256 bases, queries
       copied to every device and the counts summed on the home device;
    3. one counting batch (2 reads a shard, 128 bases) routed to its key
       shards by ``add_batch``, and the same reads through ``add_reads``
       (each device scanning its own rows); the range-partitioned tables,
       ``kmer_pairs_sharded`` against an index of the first half, and a
       checkpoint round trip;
    4. a 2-slice hierarchical group on the same devices (where n_devices is
       even) lands every key in the same shard as the flat one.

    Raises on any failed check. Prints the JAX function's line and returns
    the record: ``n_devices``, ``devices``, ``kmers_sharded``,
    ``distinct``, ``hierarchical``, ``ok`` and that ``line``."""
    mesh = make_mesh(n_devices, device=None if devices else device,
                     devices=devices)
    rng = np.random.default_rng(1)
    k = 16
    L = 4096
    seq_arr = np.asarray([65, 67, 71, 84], np.uint8)[
        rng.integers(0, 4, size=L)]
    seq = seq_arr.tobytes().decode()

    # 1) sharded index build: halo rows + routing to owners + shard sorts
    idx = ShardedKmerIndex(seq, k, mesh)
    _check(idx.total_kmers == L - k + 1,
           f"{idx.total_kmers} k-mers sharded, not {L - k + 1}")

    # 2) replicated query, counts summed over the shards
    home = mesh.device
    q, q_valid = enc.encode_stream(torch.from_numpy(seq_arr[:256]).to(home),
                                   k, 256)
    counts = idx.lookup_counts(q[q_valid])
    _check(bool((counts >= 1).all()), "a queried window was not found")

    # 3) a counting batch routed to its key shards
    store = ShardedCountStore(k, mesh, counts_n=2)
    B = n_devices * 2
    reads = np.asarray([65, 67, 71, 84], np.uint8)[
        rng.integers(0, 4, size=(B, 128))]
    reads_t = torch.from_numpy(reads).to(home)
    lens = torch.full((B,), 128, dtype=torch.int32, device=home)
    raw, valid = enc.encode_stream(reads_t, k, lens, canonical=True)
    store.add_batch(raw, valid, source=0)
    spec = store.spectrum(8)
    _check(spec.sum() == store.n_unique.sum(),
           "the spectrum does not sum to the distinct count")

    # 3b) the fused reads -> counts batch, rows dealt to the devices
    store2 = ShardedCountStore(k, mesh, counts_n=2)
    qual = torch.full((B, 128), 70, dtype=torch.uint8, device=home)
    hq = torch.ones(B, dtype=torch.bool, device=home)
    store2.add_reads(reads_t, qual, lens, hq, min_ll_f=-1e9,
                     precision="fast", source=0)
    _check(int(store2.total_added.sum()) > 0, "add_reads added nothing")

    # 3c) range-partitioned tables and the cross-index pair stream
    tabs = idx.tables(2 | 8)
    _check(tabs["pos"].shape[0] == idx.total_kmers
           and int(tabs["count"].sum()) == idx.total_kmers,
           "the tables do not hold every k-mer")
    idx_b = ShardedKmerIndex(seq[: L // 2], k, mesh)
    pairs = kmer_pairs_sharded(idx, idx_b)
    _check(pairs.shape[0] > 0 and pairs.shape[1] == 2,
           "kmer_pairs_sharded gave no (a, b) rows")

    # 3d) sharded checkpoint round trip
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/store.npz"
        ckpt.save_count_store(store, path)
        restored = ckpt.load_count_store(path, mesh=mesh)
        _check(bool((restored.n_unique == store.n_unique).all()
                    and (restored.spectrum(8) == spec).all()),
               "the restored checkpoint differs")

    # 4) a 2-slice hierarchical group: every key on the flat group's owner
    hierarchical = n_devices % 2 == 0
    if hierarchical:
        hmesh = make_hierarchical_mesh(2, n_devices // 2,
                                       device=None if devices else device,
                                       devices=devices)
        hstore = ShardedCountStore(k, hmesh, counts_n=2)
        hstore.add_batch(raw, valid, source=0)
        _check(bool((hstore.n_unique == store.n_unique).all()
                    and (hstore.spectrum(8) == spec).all()),
               "the 2-slice group differs from the flat one")

    line = (f"dryrun_multichip OK: {n_devices} devices, "
            f"{idx.total_kmers} kmers sharded, {int(store.n_unique.sum())} "
            "distinct counted (flat + 2-slice hierarchical mesh)")
    print(line)
    return {"n_devices": n_devices,
            "devices": [str(d) for d in mesh.devices],
            "kmers_sharded": idx.total_kmers,
            "distinct": int(store.n_unique.sum()),
            "hierarchical": hierarchical, "ok": True, "line": line}

