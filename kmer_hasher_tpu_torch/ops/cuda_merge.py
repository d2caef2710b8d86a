"""B3 on Hopper: the hand-written merge-path kernel and its wrapper.

Replaces ``kmer_hasher_tpu/ops/merge_sort.py::_merge_round_kernel`` (and
the ``merge_path_splits`` search that ran outside it). Source:
``csrc/merge_path.cu``, built by :mod:`._build`. The program calls it
from the count store's two-run merge (``index/count_store.merge_runs``:
the tier merges and the folds' merges) and from the ranged fold's range
pass (``CountStore._merge_range``: every pair of a key range's slices in
one launch a round, the payload carried from round to round); the DMA
probes' D4 times it at a sort round's shape, a 32-bit payload beside the
keys.

The function, the same for kernel and plain version: flat ``keys`` (int64
in the port's sortable form, so signed order is k-mer order), a payload
lane of 32 bits compared **unsigned** (held in an int32 tensor), and the
boundaries of 2P consecutive sorted runs; for each pair p the merge of run
2p (A) and run 2p+1 (B) is written over the pair's own span, ascending by
(key, payload), A's element first on a full tie. Run lengths are whatever
the boundaries say. With ``pay=None`` the payload is implicit: an element's
row number in the flat input, so the output payload names the row each
merged element came from (the count store gathers its count rows by it).

What bounds it on the card: device memory — a round reads and writes every
element once, 24 bytes per element with a payload lane, 20 with the
implicit one. A merge is two kernels, both launched by the one C entry: a
partition pass finds the split of every tile boundary once, one thread a
boundary, so no block waits on a search of its own; then one block per
output tile of 4,096 elements of one pair stages its A and B windows in
shared memory with ``cp.async``, in a padded layout free of bank
conflicts, each thread merges 16 elements serially, and the tile is written
coalesced; every pair of a round goes in one launch of each. PERF.md holds
the measured times.

:func:`merge` is the wrapper. CPU tensors take the plain version
(:func:`plain`); CUDA tensors launch the kernels or raise. Each merge adds
one to ``merge.launches`` and its element count to ``merge.rows``. The
bounds go up through pinned memory without a synchronisation, so the
upload does not wait for the kernels queued before it; what is left of the
wrapper's host time is its own Python, allocation and launch work, which at
the count store's shape is about as long as the kernels (PERF.md).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

_U32 = 0xFFFFFFFF
TILE = 4096  # output elements a block merges (kTile of merge_path.cu)


def _check_bounds(bounds: Sequence[int], n: int) -> np.ndarray:
    """Run boundaries as an int64 array [2P + 1]: an even number of runs,
    ascending from 0 to n, so the pairs tile the flat arrays."""
    b = np.asarray(bounds, np.int64).reshape(-1)
    if b.size < 3 or b.size % 2 != 1:
        raise ValueError("bounds must hold 2P + 1 run boundaries, P >= 1")
    if b[0] != 0 or b[-1] != n or (np.diff(b) < 0).any():
        raise ValueError("bounds must ascend from 0 to the arrays' length")
    return b


def plain(keys: torch.Tensor, pay: Optional[torch.Tensor],
          bounds: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B3, on any device: the merge defined by
    sorting. Three stable ``torch.sort`` passes, least significant first —
    payload (as unsigned), key, pair number — order every pair's span by
    (key, payload) and leave the pairs where they are."""
    n = int(keys.shape[0])
    b = _check_bounds(bounds, n)
    dev = keys.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    p = rows if pay is None else pay.to(torch.int64) & _U32
    edges = torch.from_numpy(b[2:-1:2].copy()).to(dev)  # starts of pairs 1..
    pair = torch.searchsorted(edges, rows, right=True)
    order = torch.sort(p, stable=True).indices
    order = order[torch.sort(keys[order], stable=True).indices]
    order = order[torch.sort(pair[order], stable=True).indices]
    # back to the 32-bit lane: values >= 2^31 become the same bits, negative
    out_p = ((p[order] ^ (1 << 31)) - (1 << 31)).to(torch.int32)
    return keys[order], out_p


def _entry():
    """The library, its typed ``kmh_merge_path`` entry and the entry that
    sizes the partition pass's scratch."""
    lib = _build.load()
    fn, scratch = lib.kmh_merge_path, lib.kmh_merge_path_scratch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        scratch.argtypes = [ll, ll]
        scratch.restype = ll
    return lib, fn, scratch


def merge(keys: torch.Tensor, pay: Optional[torch.Tensor],
          bounds: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One merge round: (merged keys int64 [n], merged payload int32 [n]).

    keys: int64 [n]; pay: int32 [n] (compared as unsigned) or None for the
    implicit row-number payload; bounds: 2P + 1 ascending run boundaries on
    the host (a sequence of ints), from 0 to n."""
    dev = keys.device
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise TypeError("expected flat int64 keys")
    if pay is not None:
        if pay.dtype != torch.int32 or pay.shape != keys.shape:
            raise TypeError("expected an int32 payload of the keys' shape")
        if pay.device != dev:
            raise ValueError("keys and payload must share a device")
    n = int(keys.shape[0])
    if pay is None and n >= 1 << 31:
        raise ValueError("the implicit row-number payload needs n < 2^31")
    if dev.type == "cpu":
        return plain(keys, pay, bounds)
    if dev.type != "cuda":
        raise ValueError(f"B3 runs on CPU or CUDA tensors, not {dev.type}")
    if not keys.is_contiguous() or not (pay is None or pay.is_contiguous()):
        raise ValueError("B3 needs contiguous inputs")
    b = _check_bounds(bounds, n)
    out_k = torch.empty(n, dtype=torch.int64, device=dev)
    out_p = torch.empty(n, dtype=torch.int32, device=dev)
    max_pair = int((b[2::2] - b[:-2:2]).max())
    if max_pair == 0:
        return out_k, out_p
    lib, fn, scratch = _entry()
    n_pairs = b.size // 2
    # one device buffer: the bounds, then the partition pass's splits
    b_dev = torch.empty(b.size + scratch(n_pairs, max_pair),
                        dtype=torch.int64, device=dev)
    # The bounds go up from pinned memory without a synchronisation. Safe
    # to drop ``host`` on return: it comes from PyTorch's caching host
    # allocator, which records an event on the stream for a non-blocking
    # copy from it and hands the block out again only once that event has
    # completed. ``b_dev`` is used only on this stream, so the caching
    # device allocator needs no more.
    host = torch.from_numpy(b).pin_memory()
    b_dev[: b.size].copy_(host, non_blocking=True)
    # The C entry makes the keys' device the thread's device; a device
    # guard is entered only where another one is current.
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    stream = torch.cuda.current_stream(index).cuda_stream
    args = (keys.data_ptr(), None if pay is None else pay.data_ptr(),
            b_dev.data_ptr(), n_pairs, max_pair, out_k.data_ptr(),
            out_p.data_ptr(), index, stream)
    if current == index:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    _build.check(lib, err, "B3 merge_path launch")
    merge.launches += 1
    merge.by_device[index] = merge.by_device.get(index, 0) + 1
    merge.rows += n
    return out_k, out_p


merge.launches = 0
merge.by_device = {}  # card index -> launches there
merge.rows = 0
