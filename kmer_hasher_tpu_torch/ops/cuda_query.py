"""Q1 and Q2 on Hopper: the bounds and the hit expansion of ``seq_kmer_pos``.

They replace no TPU kernel: the JAX package leaves both steps to XLA
(``kmer_hasher_tpu/index/query.py``). The port's plain path makes about
30 small launches a query, and the host's dispatch of them outweighed the
card's work. On a CUDA index a query is now B1, Q1, one prefix sum and a Q2
launch a chunk. Source: ``csrc/query.cu``, built by :mod:`._build`.

What bounds each on the card, and what its design does about it (the
source has the details):

- Q1 (:func:`ranges`, one thread a window): the dependent loads of a
  binary search over the index's 320 MB of sorted keys, about 26 sectors a
  window. One full search gives ``lb``; ``ub`` gallops forward from it, one
  load where a key occurs once, so the plain version's second search goes.
- Q2 (:func:`hits`, a block a tile of 2,048 rows): per row an 8-byte store
  and one scattered ``s_pos`` load. A block searches the owners of its first
  and last row over ``cum_c``, stages the prefix sums between them in shared
  memory and searches there.

A CPU tensor takes the plain version (:func:`plain_ranges`,
:func:`plain_hits`); a CUDA tensor launches the kernel or raises. Each
launch adds one to ``ranges.launches`` / ``hits.launches`` and to
``by_device`` under its card, and its windows to ``ranges.windows`` or its
rows to ``hits.rows``. The wrappers never make the host wait for the card:
no pinned staging, no readback; each output is one ``torch.empty``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from . import encode as enc
from . import sort as srt

_entries: Optional[tuple] = None  # (library, Q1's entry, Q2's entry)


def trailing_drop(seq: np.ndarray, k: int, true_len: int) -> int:
    """The window start that the trailing-exact-k quirk drops
    (``ops.encode.drop_trailing_mask``), or -1 where it drops none, read
    from the host's bytes: the window ending at ``true_len`` when it starts
    the sequence or follows an N."""
    a = int(true_len) - k
    if a < 0 or a >= seq.shape[0]:
        return -1
    if a == 0 or (int(seq[a - 1]) | 0x20) == ord("n"):
        return a
    return -1


def plain_ranges(key: torch.Tensor, valid: torch.Tensor,
                 s_key: torch.Tensor, n_valid: int, drop: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of Q1, on any device: (lb, c) int64, the
    same numbers as ``index.query._query_ranges``."""
    lb, ub = srt.lookup_bounds(s_key, n_valid, enc.sortable_key(key))
    if drop >= 0:
        valid = valid.clone()
        valid[drop] = False
    return lb, torch.where(valid, ub - lb, 0)


def plain_hits(s_pos: torch.Tensor, lb: torch.Tensor, c: torch.Tensor,
               cum_c: torch.Tensor, k: int, start: int, n: int
               ) -> torch.Tensor:
    """The plain PyTorch version of Q2, on any device: the [n, 2] int32 rows
    ``index.query._hit_chunk`` gives."""
    g = start + torch.arange(n, dtype=torch.int64, device=s_pos.device)
    w = srt.expand_rank_i64(cum_c, g, cum_c.shape[0])
    t = g - (cum_c[w] - c[w])
    return torch.stack([(w + k).to(torch.int32), s_pos[lb[w] + t]], dim=1)


def _load():
    """The library and Q1's and Q2's typed entries, resolved once."""
    global _entries
    if _entries is None:
        lib = _build.load()
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        q1, q2 = lib.kmh_query_ranges, lib.kmh_query_hits
        q1.argtypes = [p, p, ll, p, ll, ll, p, p, i, p]
        q2.argtypes = [p, p, p, ll, i, ll, ll, p, i, p]
        q1.restype = q2.restype = i
        _entries = (lib, q1, q2)
    return _entries


def _launch(fn, args: tuple, dev: torch.device, what: str) -> int:
    """Call a C entry with the device index and current stream of ``dev``
    appended; returns the device index. A device guard is entered only where
    another card is current."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    args += (index, torch.cuda.current_stream(index).cuda_stream)
    if current == index:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    _build.check(_entries[0], err, what)
    return index


def _check(dev: torch.device, what: str, **tensors) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {dev.type}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs a contiguous {name}")


def ranges(key: torch.Tensor, valid: torch.Tensor, s_key: torch.Tensor,
           n_valid: int, drop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lb, c) int64 per query window: the first row of the window's key in
    ``s_key[:n_valid]`` and, for a valid window other than ``drop``, its
    rows there (else 0). ``key`` and ``valid`` are B1's for the query."""
    if key.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError("Q1 takes B1's int64 keys and bool validity")
    if s_key.dtype != torch.int64:
        raise TypeError(f"Q1 takes int64 index keys, not {s_key.dtype}")
    if key.dim() != 1 or valid.shape != key.shape or s_key.dim() != 1:
        raise ValueError("Q1 takes 1-D keys, validity and index keys")
    if not 0 <= n_valid <= s_key.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [0, {s_key.shape[0]}]")
    dev = key.device
    if dev.type == "cpu":
        return plain_ranges(key, valid, s_key, n_valid, drop)
    _check(dev, "Q1", key=key, valid=valid, s_key=s_key)
    lb = torch.empty_like(key)
    c = torch.empty_like(key)
    n = key.shape[0]
    if n == 0:
        return lb, c
    _, fn, _ = _load()
    index = _launch(fn, (key.data_ptr(), valid.data_ptr(), n,
                         s_key.data_ptr(), n_valid, drop, lb.data_ptr(),
                         c.data_ptr()), dev, "Q1 ranges launch")
    ranges.launches += 1
    ranges.by_device[index] = ranges.by_device.get(index, 0) + 1
    ranges.windows += n
    return lb, c


def hits(s_pos: torch.Tensor, lb: torch.Tensor, c: torch.Tensor,
         cum_c: torch.Tensor, k: int, start: int, n: int) -> torch.Tensor:
    """Hit rows [n, 2] int32 = (1-based query position of the window's last
    base, 1-based start in the index) for global rows [start, start + n),
    where ``cum_c`` is the inclusive prefix sum of the counts ``c`` and
    ``start + n`` is at most its last value."""
    if s_pos.dtype != torch.int32:
        raise TypeError(f"Q2 takes int32 positions, not {s_pos.dtype}")
    if lb.dtype != torch.int64 or cum_c.dtype != torch.int64:
        raise TypeError("Q2 takes int64 lb and prefix sums")
    if lb.dim() != 1 or cum_c.shape != lb.shape or c.shape != lb.shape:
        raise ValueError("Q2 takes 1-D lb, counts and prefix sums")
    if start < 0 or n < 0:
        raise ValueError(f"rows [{start}, {start} + {n}) out of range")
    dev = lb.device
    if dev.type == "cpu":
        return plain_hits(s_pos, lb, c, cum_c, k, start, n)
    _check(dev, "Q2", s_pos=s_pos, lb=lb, cum_c=cum_c)
    out = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _, _, fn = _load()
    index = _launch(fn, (s_pos.data_ptr(), lb.data_ptr(), cum_c.data_ptr(),
                         lb.shape[0], k, start, n, out.data_ptr()), dev,
                    "Q2 hits launch")
    hits.launches += 1
    hits.by_device[index] = hits.by_device.get(index, 0) + 1
    hits.rows += n
    return out


ranges.launches = 0
ranges.by_device = {}  # card index -> launches there
ranges.windows = 0  # query windows searched by launches, for accounting
hits.launches = 0
hits.by_device = {}
hits.rows = 0  # hit rows written by launches, for accounting
