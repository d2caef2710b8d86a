"""B2 on Hopper: the hand-written quality-likelihood FSM kernel and its
wrapper.

Replaces ``kmer_hasher_tpu/ops/pallas_scan.py::_kernel`` with ``_fsm_step``
(entry ``ll_scan_pallas``). Source: ``csrc/ll_scan.cu``, built by
:mod:`._build`, in three instantiations: f32 (``precision="fast"``), f32
with the two error lanes and the per-read flag (``return_flags``), and f64
over the ``Q_TO_LL`` table (``precision="exact"``) — the TPU kernel is f32
only because the TPU emulates f64; this card does not.

What bounds it on the card: device memory — per (read, position) it reads
2 bytes (base, quality) and writes 17 (emit, two int64 registers). A thread
owns a read and keeps the FSM state in registers, with the per-quality
log-likelihood in a 256-entry shared-memory table; a warp owns 32
consecutive reads, stages their bases and qualities into shared memory
with 16-byte ``cp.async`` copies and puts its outputs out through shared
memory in chunks of 16 positions from 32-byte sector boundaries, so that
consecutive lanes store to consecutive addresses and no sector is written
in two parts (a thread storing its own row would touch 32 rows an
instruction). Blocks of one warp spread the counting path's 928 warps over
the card in one wave. PERF.md holds the measured times.

:func:`scan` is the wrapper. A CPU tensor takes the plain version
(:func:`plain`, which is ``ops.scan_iter.ll_scan``); a CUDA tensor launches
the kernel or raises. Each launch adds one to ``scan.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from . import scan_iter as si

plain = si.ll_scan


def _entry():
    """The library and its typed ``kmh_ll_scan`` entry."""
    lib = _build.load()
    fn = lib.kmh_ll_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p, i, ctypes.c_double,
                       ctypes.c_float, ctypes.c_float, p, p, p, p, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=16)
def _device_table(dev: torch.device, dtype: str, raw: bytes) -> torch.Tensor:
    """The 256-entry ll table on ``dev``, uploaded once per distinct table."""
    return torch.from_numpy(np.frombuffer(raw, dtype).copy()).to(dev)


def scan(ascii_u8: torch.Tensor, qual_u8: torch.Tensor,
         lengths: torch.Tensor, k: int, min_ll: float,
         precision: str = "exact", return_flags: bool = False,
         min_q_char: Optional[int] = None, ll_table=None,
         rel_bound: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """``ll_scan`` of a padded [B, L] read batch: (emit bool, fwd int64, rc
    int64), each [B, L], plus the per-read flag (bool [B]) with
    ``return_flags``. Arguments as :func:`ops.scan_iter.ll_scan`."""
    dev = ascii_u8.device
    if dev.type == "cpu":
        return plain(ascii_u8, qual_u8, lengths, k, min_ll, precision,
                     return_flags, min_q_char, ll_table, rel_bound)
    if dev.type != "cuda":
        raise ValueError(f"B2 runs on CPU or CUDA tensors, not {dev.type}")
    if not 1 <= k <= 32:
        raise ValueError("k must be in 1..32")
    if ascii_u8.dim() != 2 or qual_u8.shape != ascii_u8.shape:
        raise ValueError("expected [B, L] bases and qualities of one shape")
    if ascii_u8.dtype != torch.uint8 or qual_u8.dtype != torch.uint8:
        raise TypeError("expected uint8 bases and qualities")
    if qual_u8.device != dev or lengths.device != dev:
        raise ValueError("bases, qualities and lengths must share a device")
    if not (ascii_u8.is_contiguous() and qual_u8.is_contiguous()):
        raise ValueError("B2 needs contiguous inputs")
    B, L = ascii_u8.shape
    lens = lengths.to(torch.int32).reshape(-1).contiguous()
    if lens.numel() != B:
        raise ValueError(f"{lens.numel()} lengths for {B} rows")
    cst = si.scan_consts(min_ll, precision, return_flags, min_q_char,
                         ll_table, rel_bound)
    variant = 2 if precision == "exact" else int(return_flags)
    table = _device_table(dev, cst.table.dtype.str, cst.table.tobytes())
    emit = torch.empty((B, L), dtype=torch.bool, device=dev)
    fwd = torch.empty((B, L), dtype=torch.int64, device=dev)
    rc = torch.empty((B, L), dtype=torch.int64, device=dev)
    flag = torch.empty(B if return_flags else 0, dtype=torch.bool,
                       device=dev)
    if B * L:
        lib, fn = _entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(ascii_u8.data_ptr(), qual_u8.data_ptr(),
                     lens.data_ptr(), B, L, k, table.data_ptr(), variant,
                     cst.min_ll, cst.rel, cst.merr, emit.data_ptr(),
                     fwd.data_ptr(), rc.data_ptr(),
                     flag.data_ptr() if return_flags else None,
                     torch.cuda.current_device(), stream)
        _build.check(lib, err, "B2 ll_scan launch")
        scan.launches += 1
        scan.by_device[dev.index] = scan.by_device.get(dev.index, 0) + 1
    if return_flags:
        return emit, fwd, rc, flag
    return emit, fwd, rc


scan.launches = 0
scan.by_device = {}  # card index -> launches there
