"""P5–P8 on Hopper: the round-3 sort probes' hand-written kernels and their
wrappers.

Replace the four Pallas kernels of ``tools/chip_probes/sort_probes_r3.py``
in the JAX package (``r2_dyn_dma_2d``, ``r2b_small_dma_rate``,
``r3_dyn_dma_1d``, ``r4_vmem_gather``). Sources:
``csrc/probe_dyn_copy_2d.cu``, ``csrc/probe_small_copy.cu``,
``csrc/probe_async_copy.cu``, ``csrc/probe_smem_gather.cu``, built by
:mod:`..ops._build`. All four move 32-bit elements and never look at them;
the tensors are int32 (the JAX probes' uint32 bits).

=====  ======================  =============================================
P5     :func:`dyn_copy_2d`     for t in order: ``out[offs[T-1-t]:+R] =
                               x[offs[t]:+R]`` on rows of 128, ``out`` zero
                               before; where write windows meet, the later
                               step's rows stand
P6     :func:`small_copy`      ``out[i*4:(i+1)*4] = x[offs[i]:+4]``: a gather
                               of 2 KB records
P7     :func:`async_copy`      P2's function (``cuda_probes.dyn_copy``)
                               through ``cp.async``
P8     :func:`smem_gather`     ``out = tab.reshape(-1)[idx]``, a 1,024-entry
                               table in shared memory; an index outside
                               [0, 1024) gives 0
=====  ======================  =============================================

Each wrapper takes its plain version (``plain_*``) for CPU tensors; for CUDA
tensors it launches the kernel or raises, and adds one to its ``launches``.
The host never reads ``offs`` or ``idx``. The plain version of P5 does read
the offsets back: its definition is a loop in step order.
"""
from __future__ import annotations

import torch

from .cuda_probes import (_I, _LL, _P, _check, _launch, plain_dyn_copy,
                          window_copy)

COLS = 128  # elements per row of P5 and P6
SMALL_ROWS = 4  # rows per record of P6: 2 KB
TABLE = 1 << 10  # entries of P8's table


def plain_dyn_copy_2d(x: torch.Tensor, offs: torch.Tensor, r: int
                      ) -> torch.Tensor:
    """The plain PyTorch version of P5, and its definition: the steps in
    order on a zero-filled output. A step whose read or write window does
    not lie inside ``x`` is skipped."""
    out = torch.zeros_like(x)
    rows = x.shape[0]
    o = offs.tolist()
    for t, src in enumerate(o):
        dst = o[len(o) - 1 - t]
        if 0 <= src <= rows - r and 0 <= dst <= rows - r:
            out[dst: dst + r] = x[src: src + r]
    return out


def plain_small_copy(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P6: a gather of rows ``offs[i] + j``;
    a record whose window does not lie inside ``x`` is zeros."""
    rows = x.shape[0]
    o = offs.to(torch.int64)
    ok = (o >= 0) & (o <= rows - SMALL_ROWS)
    j = torch.arange(SMALL_ROWS, dtype=torch.int64, device=x.device)
    rec = x[torch.where(ok, o, 0)[:, None] + j]  # [n, 4, 128]
    return torch.where(ok[:, None, None], rec, 0).reshape(-1, COLS)


def plain_async_copy(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P7: P2's."""
    return plain_dyn_copy(x, offs)


def plain_smem_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P8: ``tab.reshape(-1)[idx]``, 0 where
    the index lies outside the table."""
    flat = tab.reshape(-1)
    ok = (idx >= 0) & (idx < flat.shape[0])
    return torch.where(ok, flat[torch.where(ok, idx, 0).to(torch.int64)], 0)


def _rows_and_offsets(what: str, x: torch.Tensor, offs: torch.Tensor,
                      r: int) -> None:
    """The argument checks P5 and P6 share, for either device."""
    if x.dim() != 2 or x.shape[1] != COLS or offs.dim() != 1:
        raise ValueError(f"{what} takes x [rows, {COLS}] and a flat offs")
    if x.shape[0] < r:
        raise ValueError(f"x must hold at least {r} rows")
    if offs.dtype != torch.int32 or x.dtype != torch.int32:
        raise TypeError(f"expected int32 x and offs, got {x.dtype} and "
                        f"{offs.dtype}")
    if offs.device != x.device:
        raise ValueError(f"offs lies on {offs.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{what} runs on CPU or CUDA tensors, not {x.device.type}")


def dyn_copy_2d(x: torch.Tensor, offs: torch.Tensor, r: int) -> torch.Tensor:
    """P5: for t = 0..T-1 in order, rows ``offs[t] : +r`` of ``x``
    [rows, 128] to rows ``offs[T-1-t] : +r`` of an output of ``x``'s shape
    that starts as zeros; offsets in [0, rows - r]. On the card the kernel
    writes each row of the output once, from the last step that writes it
    or zeros, so the output is never zero-filled first."""
    r = int(r)
    if r < 1:
        raise ValueError("r must be at least 1")
    _rows_and_offsets("P5", x, offs, r)
    if x.device.type == "cpu":
        return plain_dyn_copy_2d(x, offs, r)
    _check(x, "x", x.device)
    _check(offs, "offs", x.device)
    # no zero fill: the kernel writes every row, zeros where no step does
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    # per row of the output, the last step that writes it: the kernel's
    # first pass fills it, its second copies by it
    owner = torch.full((x.shape[0],), -1, dtype=torch.int32, device=x.device)
    _launch(dyn_copy_2d, "kmh_probe_dyn_copy_2d",
            [_P, _LL, _P, _I, _I, _P, _P, _I, _P], x.device, x.data_ptr(),
            x.shape[0], offs.data_ptr(), int(offs.shape[0]), r,
            owner.data_ptr(), out.data_ptr())
    return out


def small_copy(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """P6: ``len(offs)`` records of 4 rows of ``x`` [rows, 128], each from
    its own row offset in [0, rows - 4], one after the other in the output
    [len(offs) * 4, 128]."""
    _rows_and_offsets("P6", x, offs, SMALL_ROWS)
    if x.device.type == "cpu":
        return plain_small_copy(x, offs)
    _check(x, "x", x.device)
    _check(offs, "offs", x.device)
    n_rec = int(offs.shape[0])
    out = torch.empty((n_rec * SMALL_ROWS, COLS), dtype=torch.int32,
                      device=x.device)
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    if n_rec:
        _launch(small_copy, "kmh_probe_small_copy",
                [_P, _LL, _P, _LL, _I, _P, _I, _P], x.device, x.data_ptr(),
                x.shape[0], offs.data_ptr(), n_rec, SMALL_ROWS,
                out.data_ptr())
    return out


def async_copy(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """P7: ``cuda_probes.dyn_copy``'s contract, staged with ``cp.async``:
    ``len(offs)`` windows of CH elements of flat ``x``, each from its own
    element offset in [0, len(x) - CH]."""
    return window_copy(async_copy, "kmh_probe_async_copy", plain_async_copy,
                       "P7", x, offs)


def smem_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P8: ``tab.reshape(-1)[idx]`` for a table of 1,024 entries and int32
    indices of any shape (a multiple of 4 of them on the card); 0 where an
    index lies outside [0, 1024)."""
    if tab.numel() != TABLE:
        raise ValueError(f"the table must hold {TABLE} entries")
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"expected int32 tab and idx, got {tab.dtype} and "
                        f"{idx.dtype}")
    if idx.device != tab.device:
        raise ValueError(f"idx lies on {idx.device}, tab on {tab.device}")
    if tab.device.type == "cpu":
        return plain_smem_gather(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(
            f"P8 runs on CPU or CUDA tensors, not {tab.device.type}")
    _check(tab, "tab", tab.device)
    _check(idx, "idx", tab.device)
    out = torch.empty_like(idx)
    if idx.numel() % 4 or any(t.data_ptr() % 16 for t in (tab, idx, out)):
        raise ValueError("on the card idx must hold a multiple of 4 elements "
                         "and tab and idx start on a 16-byte boundary")
    if idx.numel():
        _launch(smem_gather, "kmh_probe_smem_gather",
                [_P, _I, _P, _LL, _P, _I, _P], tab.device, tab.data_ptr(),
                TABLE, idx.data_ptr(), idx.numel(), out.data_ptr())
    return out


dyn_copy_2d.launches = 0
small_copy.launches = 0
async_copy.launches = 0
smem_gather.launches = 0
