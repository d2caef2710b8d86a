"""P9 and P10 on Hopper: the round-3 DMA probes' hand-written kernels and
their wrappers.

Replace the two Pallas kernels of ``tools/chip_probes/dma_probes_r3.py`` in
the JAX package (``d1_pipelined_dyn_dma``, ``d3_gather_2d``). Sources:
``csrc/probe_pipelined_copy.cu`` (with the ownership pass of
``csrc/probe_owner.cuh``, shared with P5) and ``csrc/probe_lane_gather.cu``,
built by :mod:`..ops._build`. Both move 32-bit elements and never look at
them; the tensors are int32 (the JAX probes' uint32 bits).

=====  ========================  ===========================================
P9     :func:`pipelined_copy`    P5's function (``cuda_probes_r3``): for t in
                                 order ``out[offs[T-1-t]:+R] = x[offs[t]:+R]``
                                 on rows of 128, ``out`` zero before, the
                                 later step's rows standing where windows
                                 meet; through a ring of shared-memory stages
                                 filled and drained by bulk copies. With
                                 ``offs=None`` (D2, the JAX probe's
                                 ``dynamic=False``) the offsets are ``t*R``
                                 and ``(T-1-t)*R`` for T = rows // R,
                                 computed in the kernel, not read
P10    :func:`lane_gather`       ``out[r, c] = tab[idx[r, c], c]`` for a
                                 [1024, 128] table: a lookup table per lane;
                                 an index outside [0, 1024) gives 0
=====  ========================  ===========================================

Each wrapper takes its plain version (``plain_*``) for CPU tensors; for CUDA
tensors it launches the kernel or raises, and adds one to its ``launches``.
The host never reads ``offs`` or ``idx``. The plain version of P9 does read
the offsets back: its definition is a loop in step order.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cuda_probes import _I, _LL, _P, _check, _launch
from .cuda_probes_r3 import COLS, _rows_and_offsets, plain_dyn_copy_2d

TABLE_ROWS = 1 << 10  # rows of P10's table: [1024, 128], 512 KB
LANE_TASK = 16  # rows of one task of a warp of P10


def static_offsets(rows: int, r: int, device) -> torch.Tensor:
    """D2's offsets as P9's plain version takes them: ``t * r`` for the
    T = rows // r steps (the write offsets are the same list reversed)."""
    return torch.arange(0, (rows // r) * r, r, dtype=torch.int32,
                        device=device)


def plain_pipelined_copy(x: torch.Tensor, offs: Optional[torch.Tensor],
                         r: int) -> torch.Tensor:
    """The plain PyTorch version of P9: P5's, the steps in order on a
    zero-filled output; with ``offs=None`` D2's computed offsets."""
    if offs is None:
        offs = static_offsets(x.shape[0], r, x.device)
    return plain_dyn_copy_2d(x, offs, r)


def plain_lane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of P10: ``torch.gather`` along the table's
    rows, 0 where the index lies outside [0, 1024)."""
    ok = (idx >= 0) & (idx < TABLE_ROWS)
    got = torch.gather(tab, 0, torch.where(ok, idx, 0).to(torch.int64))
    return torch.where(ok, got, 0)


def pipelined_copy(x: torch.Tensor, offs: Optional[torch.Tensor], r: int
                   ) -> torch.Tensor:
    """P9: for t = 0..T-1 in order, rows ``offs[t] : +r`` of ``x``
    [rows, 128] to rows ``offs[T-1-t] : +r`` of a zero-filled output of
    ``x``'s shape; offsets in [0, rows - r]. ``offs=None`` is D2: T = rows
    // r steps from row ``t * r`` to row ``(T-1-t) * r``."""
    r = int(r)
    if r < 1:
        raise ValueError("r must be at least 1")
    dynamic = offs is not None
    if dynamic:
        _rows_and_offsets("P9", x, offs, r)
    else:
        if x.dim() != 2 or x.shape[1] != COLS:
            raise ValueError(f"P9 takes x [rows, {COLS}]")
        if x.shape[0] < r:
            raise ValueError(f"x must hold at least {r} rows")
        if x.dtype != torch.int32:
            raise TypeError(f"expected int32 x, got {x.dtype}")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"P9 runs on CPU or CUDA tensors, not {x.device.type}")
    if x.device.type == "cpu":
        return plain_pipelined_copy(x, offs, r)
    _check(x, "x", x.device)
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    rows = int(x.shape[0])
    steps = rows // r
    owner = None
    if dynamic:
        _check(offs, "offs", x.device)
        steps = int(offs.shape[0])
        # per row of the output, the last step that writes it (-1: none)
        owner = torch.full((rows,), -1, dtype=torch.int32, device=x.device)
    elif steps * r < rows:
        out[steps * r:].zero_()  # no step of D2 writes these rows
    _launch(pipelined_copy, "kmh_probe_pipelined_copy",
            [_P, _LL, _P, _I, _I, _I, _P, _P, _I, _P], x.device,
            x.data_ptr(), rows, offs.data_ptr() if dynamic else None, steps,
            r, int(dynamic), owner.data_ptr() if dynamic else None,
            out.data_ptr())
    return out


def lane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P10: ``out[r, c] = tab[idx[r, c], c]`` for ``tab`` [1024, 128] and
    int32 ``idx`` [rows, 128]; 0 where an index lies outside [0, 1024)."""
    if tab.shape != (TABLE_ROWS, COLS):
        raise ValueError(f"the table must be [{TABLE_ROWS}, {COLS}]")
    if idx.dim() != 2 or idx.shape[1] != COLS:
        raise ValueError(f"P10 takes idx [rows, {COLS}]")
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"expected int32 tab and idx, got {tab.dtype} and "
                        f"{idx.dtype}")
    if idx.device != tab.device:
        raise ValueError(f"idx lies on {idx.device}, tab on {tab.device}")
    if tab.device.type == "cpu":
        return plain_lane_gather(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(
            f"P10 runs on CPU or CUDA tensors, not {tab.device.type}")
    _check(tab, "tab", tab.device)
    _check(idx, "idx", tab.device)
    out = torch.empty_like(idx)
    if idx.shape[0]:
        _launch(lane_gather, "kmh_probe_lane_gather",
                [_P, _I, _I, _P, _LL, _P, _I, _P], tab.device,
                tab.data_ptr(), TABLE_ROWS, COLS, idx.data_ptr(),
                int(idx.shape[0]), out.data_ptr())
    return out


pipelined_copy.launches = 0
lane_gather.launches = 0
