"""B3 on Hopper: the hand-written merge-path kernel and its wrapper.

Replaces ``kmer_hasher_tpu/ops/merge_sort.py::_merge_round_kernel`` (and
the ``merge_path_splits`` search that ran outside it). Source:
``csrc/merge_path.cu``, built by :mod:`._build`.

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
implicit one. One block per output tile of 2,048 elements of one pair finds
its two diagonal split points in device memory, stages its A and B windows
in shared memory, each thread merges 8 elements serially, and the tile is
written coalesced; every pair of a round goes in one launch. PERF.md holds
the measured times.

:func:`merge` is the wrapper. CPU tensors take the plain version
(:func:`plain`); CUDA tensors launch the kernel or raise. Each launch adds
one to ``merge.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

_U32 = 0xFFFFFFFF


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
    """The library and its typed ``kmh_merge_path`` entry."""
    lib = _build.load()
    fn = lib.kmh_merge_path
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib, fn


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
    # the bounds go up on the launch's stream; the caching allocator hands
    # their memory out again only to later work on that stream
    b_dev = torch.from_numpy(b).to(dev)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(keys.data_ptr(), None if pay is None else pay.data_ptr(),
                 b_dev.data_ptr(), b.size // 2, max_pair, out_k.data_ptr(),
                 out_p.data_ptr(), torch.cuda.current_device(), stream)
    _build.check(lib, err, "B3 merge_path launch")
    merge.launches += 1
    return out_k, out_p


merge.launches = 0
