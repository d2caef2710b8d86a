"""B1 on Hopper: the hand-written CUDA encode kernel and its wrapper.

Replaces ``kmer_hasher_tpu/ops/pallas_encode.py::_kernel`` (entries
``pallas_encode`` and ``pallas_encode_batch``). Source: ``csrc/encode.cu``,
built by :mod:`._build`.

What bounds it on the card: device memory, by design. Per position the
kernel reads 1 byte and writes 9 (int64 key, bool validity); the
arithmetic is a few integer ops per base. The design keeps to that: one
thread per window start over a shared-memory tile with a (k-1)-byte halo,
every input byte read from device memory about once, every output written
once, coalesced. A batch [B, L] is one flat stream whose windows stop at
their row's end. Measured on an H100 80GB HBM3 at 700 W (2^26 bytes,
k=32): about 1.75 ms, 11% of the card's 3.35 TB/s: this first version is
not yet memory-bound. The likely cost, untested, is per-thread work (a
64-bit division and a k-step byte loop).

:func:`encode` is the wrapper. A CPU tensor takes the plain version
(:func:`plain`); a CUDA tensor launches the kernel or raises. Each launch
adds one to ``encode.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from . import encode as enc


def plain(ascii_u8: torch.Tensor, k: int, true_len
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B1, on any device: (raw key, valid)."""
    return (enc.encode_windows(enc.base_codes(ascii_u8), k),
            enc.window_valid(ascii_u8, k, true_len))


def _entry():
    """The library and its typed ``kmh_encode`` entry."""
    lib = _build.load()
    fn = lib.kmh_encode
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, ctypes.c_longlong, p,
                       ctypes.c_int, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib, fn


def encode(ascii_u8: torch.Tensor, k: int, true_len
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw key int64, valid bool) per window start of a 1-D sequence
    (scalar ``true_len``) or a [B, L] batch (one length per row)."""
    if not 1 <= k <= 32:
        raise ValueError("k must be in 1..32")
    if ascii_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 bytes, got {ascii_u8.dtype}")
    if ascii_u8.dim() not in (1, 2):
        raise ValueError("expected a 1-D sequence or a [B, L] batch")
    dev = ascii_u8.device
    if dev.type == "cpu":
        return plain(ascii_u8, k, true_len)
    if dev.type != "cuda":
        raise ValueError(f"B1 runs on CPU or CUDA tensors, not {dev.type}")
    if not ascii_u8.is_contiguous():
        raise ValueError("B1 needs a contiguous input")
    rows = 1 if ascii_u8.dim() == 1 else ascii_u8.shape[0]
    lengths = torch.as_tensor(true_len, dtype=torch.int32, device=dev)
    lengths = lengths.reshape(-1).contiguous()
    if lengths.numel() != rows:
        raise ValueError(f"{lengths.numel()} lengths for {rows} rows")
    key = torch.empty(ascii_u8.shape, dtype=torch.int64, device=dev)
    valid = torch.empty(ascii_u8.shape, dtype=torch.bool, device=dev)
    n = ascii_u8.numel()
    if n == 0:
        return key, valid
    lib, fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ascii_u8.data_ptr(), n, ascii_u8.shape[-1],
                 lengths.data_ptr(), k, key.data_ptr(), valid.data_ptr(),
                 torch.cuda.current_device(), stream)
    _build.check(lib, err, "B1 encode launch")
    encode.launches += 1
    return key, valid


encode.launches = 0
