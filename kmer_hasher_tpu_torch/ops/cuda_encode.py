"""B1 on Hopper: the hand-written CUDA encode kernel and its wrapper.

Replaces ``kmer_hasher_tpu/ops/pallas_encode.py::_kernel`` (entries
``pallas_encode`` and ``pallas_encode_batch``). Source: ``csrc/encode.cu``,
built by :mod:`._build`.

What bounds it on the card: device memory. Per position the kernel reads 1
byte and writes 9 (int64 key, bool validity). The first version, one thread
a window start with a k-step byte loop and a 64-bit division for the row,
was bound by instruction issue at 12% of that bound (1.6724 ms at 2^26
bytes, k=32, NVIDIA H100 80GB HBM3, 700.00 W). This one encodes each base
once per block: a block packs a tile of TILE window starts and their
31-byte halo into 2-bit codes and N flags in shared memory and takes each
window's key and N test as funnel shifts of neighbouring chunks; rows are
stepped, not divided: 0.2344 ms, 85% of the bound. A batch [B, L] is one
flat stream whose windows stop at their row's end. The source has the
details.

:func:`encode` is the wrapper. A CPU tensor takes the plain version
(:func:`plain`); a CUDA tensor launches the kernel or raises. Each launch
adds one to ``encode.launches`` and its window starts to
``encode.positions``. The wrapper never makes the host wait for
the card: a scalar length is a kernel argument, per-row lengths on the host
go up from pinned memory without a synchronisation, and per-row lengths on
the card are used there.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build
from . import encode as enc

TILE = 4096  # window starts a block of the kernel encodes (kTile)


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
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, p, ll, ctypes.c_int, p, p, ctypes.c_int,
                       p]
        fn.restype = ctypes.c_int
    return lib, fn


def _device_lengths(true_len, rows: int, dev: torch.device):
    """(per-row int32 lengths on ``dev`` or None, the one length of every
    row): a scalar stays on the host; per-row lengths on the host go up
    from pinned memory without a synchronisation; per-row lengths on a card
    are cast there."""
    if isinstance(true_len, torch.Tensor) and true_len.is_cuda:
        lengths = true_len.to(dev, torch.int32).reshape(-1).contiguous()
    elif np.ndim(true_len) == 0:
        return None, int(true_len)
    else:
        # Safe to drop ``host`` on return: PyTorch's caching host allocator
        # records an event on the stream for a non-blocking copy from it
        # and hands the block out again only once that event has completed.
        host = torch.as_tensor(np.asarray(true_len), dtype=torch.int32)
        host = host.reshape(-1).contiguous().pin_memory()
        lengths = torch.empty(host.shape, dtype=torch.int32, device=dev)
        lengths.copy_(host, non_blocking=True)
    if lengths.numel() != rows:
        raise ValueError(f"{lengths.numel()} lengths for {rows} rows")
    return lengths, 0


def encode(ascii_u8: torch.Tensor, k: int, true_len
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw key int64, valid bool) per window start of a 1-D sequence
    (scalar ``true_len``) or a [B, L] batch (one length per row, or one
    scalar for every row)."""
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
    lengths, length = _device_lengths(true_len, rows, dev)
    key = torch.empty(ascii_u8.shape, dtype=torch.int64, device=dev)
    valid = torch.empty(ascii_u8.shape, dtype=torch.bool, device=dev)
    n = ascii_u8.numel()
    if n == 0:
        return key, valid
    lib, fn = _entry()
    # The C entry makes the input's device the thread's device; a device
    # guard is entered only where another one is current.
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    args = (ascii_u8.data_ptr(), n, ascii_u8.shape[-1],
            None if lengths is None else lengths.data_ptr(), length, k,
            key.data_ptr(), valid.data_ptr(), index,
            torch.cuda.current_stream(index).cuda_stream)
    if current == index:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    _build.check(lib, err, "B1 encode launch")
    encode.launches += 1
    encode.by_device[index] = encode.by_device.get(index, 0) + 1
    encode.positions += n
    return key, valid


encode.launches = 0
encode.by_device = {}  # card index -> launches there
encode.positions = 0  # window starts encoded by launches, for accounting
