"""P1–P4 on Hopper: the sort-design probes' hand-written kernels and their
wrappers.

Replace the four Pallas kernels of ``tools/chip_probes/sort_probes.py`` in
the JAX package (``e1_copy_bandwidth``, ``e2_dynamic_dma``,
``e3_traced_roll``, ``e3b_traced_roll_flat``). Sources:
``csrc/probe_copy.cu``, ``csrc/probe_dyn_copy.cu``, ``csrc/probe_roll.cu``,
built by :mod:`..ops._build`. All four move 32-bit elements and never look
at them; the tensors are int32 (the JAX probes' uint32 bits).

=====  =====================  ==============================================
P1     :func:`copy`           ``out = x``
P2     :func:`dyn_copy`       ``out[t*CH:(t+1)*CH] = x[offs[t]:offs[t]+CH]``,
                              ``offs`` int32 on the device, CH = 2^13
P3     :func:`roll_rows`      ``np.roll(tile, s, axis=0)`` of [rows, cols]
                              tiles, one int32 shift per tile on the device
P4     :func:`roll_flat`      ``np.roll(tile.reshape(-1), s)`` of the same
=====  =====================  ==============================================

What bounds each on the card is device memory: 8 bytes per element. The
sources say what each design does about it.

Each wrapper takes its plain version (``plain_*``) for CPU tensors; for CUDA
tensors it launches the kernel or raises, and adds one to its ``launches``.
The host never reads ``offs`` or the shifts: that a kernel takes them from
device memory is what P2–P4 probe. The plain rotations do read the shifts
back, as ``torch.roll`` needs Python integers.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import _build

CH = 1 << 13  # elements per tile of P2
MAX_TILE = 1 << 13  # most elements of one P3/P4 tile (32 KB of shared memory)
# elements one block of P1 copies: 1,024 threads x 16 bytes (x 4 bytes
# where x or out is not 16-byte aligned: COPY_TILE / 4)
COPY_TILE = 1 << 12


def plain_copy(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P1."""
    return x.clone()


def plain_dyn_copy(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P2: a gather of ``offs[t] + j``."""
    j = torch.arange(CH, dtype=torch.int64, device=x.device)
    return x[offs.to(torch.int64)[:, None] + j].reshape(-1)


def _plain_roll(x: torch.Tensor, shifts: torch.Tensor, flat: bool
                ) -> torch.Tensor:
    tiles = x.reshape((-1,) + x.shape[-2:])
    out = [torch.roll(t.reshape(-1), s).reshape(t.shape) if flat
           else torch.roll(t, s, dims=0)
           for t, s in zip(tiles, shifts.reshape(-1).tolist())]
    return torch.stack(out).reshape(x.shape) if out else x.clone()


def plain_roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P3: ``torch.roll`` along the rows of
    every [rows, cols] tile, the shifts read back to the host."""
    return _plain_roll(x, shifts, flat=False)


def plain_roll_flat(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P4: ``torch.roll`` of every flattened
    tile, the shifts read back to the host."""
    return _plain_roll(x, shifts, flat=True)


_ENTRIES: dict = {}  # C entry name -> (library, typed function)


def _entry(name: str, argtypes: list):
    """The library and its C entry ``name``, typed on first use and kept:
    a launch takes no lock and looks nothing up."""
    got = _ENTRIES.get(name)
    if got is None:
        lib = _build.load()
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        got = _ENTRIES[name] = (lib, fn)
    return got


def _check(t: torch.Tensor, what: str, dev: torch.device) -> None:
    """What every kernel argument must be: int32, contiguous, on ``dev``."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{what} lies on {t.device}, not on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(wrapper, name: str, argtypes: list, dev: torch.device, *args
            ) -> None:
    """Call C entry ``name`` with ``args``, the device's index and its
    current stream; raise on a CUDA error, else count one launch of
    ``wrapper``. The C entry makes ``dev`` the thread's device; where
    another one is current, it is made current around the call and the
    other restored after, as PyTorch's device guard does. The stream is
    asked for on every call, so that a ``torch.cuda.stream`` context
    holds."""
    lib, fn = _entry(name, argtypes)
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    stream = torch.cuda.current_stream(index).cuda_stream
    if current == index:
        err = fn(*args, index, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, index, stream)
    if err:
        _build.check(lib, err, f"{name} launch")
    wrapper.launches += 1


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def copy(x: torch.Tensor) -> torch.Tensor:
    """P1: a copy of ``x`` (int32, any shape, contiguous)."""
    if x.device.type == "cpu":
        return plain_copy(x)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"P1 runs on CPU or CUDA tensors, not {dev.type}")
    _check(x, "x", dev)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        _launch(copy, "kmh_probe_copy", [_P, _P, _LL, _I, _P], dev,
                x.data_ptr(), out.data_ptr(), n)
    return out


def window_copy(wrapper, entry: str, plain, what: str, x: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    """The contract P2 and P7 share: ``len(offs)`` windows of CH elements
    of flat int32 ``x``, each from its own int32 element offset, through C
    entry ``entry`` on the card (counted on ``wrapper``) or ``plain`` on the
    CPU."""
    if x.dim() != 1 or offs.dim() != 1:
        raise ValueError(f"{what} takes a flat x and a flat offs")
    if x.shape[0] < CH:
        raise ValueError(f"x must hold at least CH = {CH} elements")
    if offs.dtype != torch.int32:
        raise TypeError(f"offs: expected int32, got {offs.dtype}")
    if x.device.type == "cpu":
        if x.dtype != torch.int32 or offs.device != x.device:
            raise TypeError("expected int32 x and offs on one device")
        return plain(x, offs)
    if x.device.type != "cuda":
        raise ValueError(
            f"{what} runs on CPU or CUDA tensors, not {x.device.type}")
    _check(x, "x", x.device)
    _check(offs, "offs", x.device)
    tiles = int(offs.shape[0])
    out = torch.empty(tiles * CH, dtype=torch.int32, device=x.device)
    if tiles:
        _launch(wrapper, entry, [_P, _LL, _P, _I, _I, _P, _I, _P], x.device,
                x.data_ptr(), x.shape[0], offs.data_ptr(), tiles, CH,
                out.data_ptr())
    return out


def dyn_copy(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """P2: ``tiles = len(offs)`` windows of CH elements of flat ``x``, each
    from its own element offset ``offs[t]`` in [0, len(x) - CH], one after
    the other in the output [tiles * CH]."""
    return window_copy(dyn_copy, "kmh_probe_dyn_copy", plain_dyn_copy, "P2",
                       x, offs)


def _roll(wrapper, plain, x: torch.Tensor, shifts: torch.Tensor, flat: bool
          ) -> torch.Tensor:
    if x.dim() < 2:
        raise ValueError("expected [..., rows, cols] tiles")
    rows, cols = int(x.shape[-2]), int(x.shape[-1])
    n_tile = rows * cols
    tiles = x.numel() // n_tile if n_tile else 0
    if shifts.dtype != torch.int32 or shifts.numel() != tiles:
        raise TypeError("expected one int32 shift per tile")
    if x.device.type == "cpu":
        if x.dtype != torch.int32 or shifts.device != x.device:
            raise TypeError("expected int32 x and shifts on one device")
        return plain(x, shifts)
    if x.device.type != "cuda":
        raise ValueError(
            f"the rotation runs on CPU or CUDA tensors, not {x.device.type}")
    _check(x, "x", x.device)
    _check(shifts, "shifts", x.device)
    if n_tile % 4 or not 4 <= n_tile <= MAX_TILE:
        raise ValueError(f"a tile must hold a multiple of 4 elements, at "
                         f"most {MAX_TILE}; got [{rows}, {cols}]")
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("the tiles must start on a 16-byte boundary")
    if tiles:
        _launch(wrapper, "kmh_probe_roll", [_P, _P, _I, _I, _I, _P, _I, _P],
                x.device, x.data_ptr(), shifts.data_ptr(), tiles, n_tile,
                1 if flat else cols, out.data_ptr())
    return out


def roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P3: every [rows, cols] tile of ``x`` [..., rows, cols] rotated along
    its rows by its own shift (int32, one per tile, any sign and size)."""
    return _roll(roll_rows, plain_roll_rows, x, shifts, flat=False)


def roll_flat(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """P4: every tile of ``x`` [..., rows, cols] flattened, rotated by its
    own shift, and given its shape back."""
    return _roll(roll_flat, plain_roll_flat, x, shifts, flat=True)


copy.launches = 0
dyn_copy.launches = 0
roll_rows.launches = 0
roll_flat.launches = 0
