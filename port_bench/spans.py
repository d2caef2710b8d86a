"""The program's own spans in a ``--trace 1`` window.

``kmer_hasher_tpu_torch`` opens a ``record_function`` range named ``kmh.*``
at each of its layer boundaries while a profiler records
(``kmer_hasher_tpu_torch/utils/trace.py``), on the clock that stamps the
device's activities. Here every instant of the traced window is given to
the innermost program span under way at it, or to :data:`OUTSIDE` where
none is, and that timeline is laid over the device's busy union (every
kernel, copy and fill: ``Trace.busy``) and over the union of its kernels
alone (activities whose names start with neither ``Memcpy`` nor
``Memset``). Every idle interval is swept, however short.

For each span name, and for :data:`OUTSIDE`:

- ``host_s``: inclusive seconds, the union of the name's ranges;
- ``self_s``: seconds as the innermost span;
- ``idle_s``: the self seconds with no device activity;
- ``kernel_s``: the inclusive seconds with a kernel running;
- ``launches``: the host's kernel-launch calls (``cudaLaunchKernel*``,
  ``cuLaunchKernel*``) that start inside the name's ranges;
- ``n``: the name's ranges.

The self seconds of all names and ``OUTSIDE`` tile the window, so their
idle seconds sum to the window's idle seconds. A trace with no ``kmh.*``
range (a program without spans) or with no device activity (a CPU run)
gives no table, and a metric that reads it gives nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from port_bench.trace import merge_intervals

PREFIX = "kmh."
OUTSIDE = "outside"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
NOT_KERNELS = ("Memcpy", "Memset")
FIELDS = ("host_s", "self_s", "idle_s", "kernel_s", "launches", "n")


class _Union:
    """Merged, sorted intervals [a, b) and the length they cover below any
    instant."""

    def __init__(self, iv: List[Tuple[int, int]]):
        self.a = np.array([a for a, _b in iv], np.int64)
        self.b = np.array([b for _a, b in iv], np.int64)
        self.before = np.concatenate([[0], np.cumsum(self.b - self.a)])

    def upto(self, t: np.ndarray) -> np.ndarray:
        """Nanoseconds covered in (-inf, t), for each instant of ``t``."""
        t = np.asarray(t, np.int64)
        if not self.a.size:
            return np.zeros_like(t)
        i = np.searchsorted(self.a, t, side="right") - 1
        j = np.maximum(i, 0)
        inside = np.minimum(t, self.b[j]) - self.a[j]
        return np.where(i >= 0, self.before[j] + inside, 0)

    def within(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        return self.upto(y) - self.upto(x)


def _segments(spans: List[Tuple[int, int, str]], t0: int, t1: int
              ) -> List[Tuple[int, int, str]]:
    """The window cut at every span edge, each piece with its innermost
    open span (a range that outlives its parent is cut at the parent's
    end, so the open ranges always nest)."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, name), ends falling
    at = t0

    def upto(t: int) -> None:
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > at:
                segs.append((at, end, name))
                at = end
        if t > at:
            segs.append((at, t, stack[-1][1] if stack else OUTSIDE))
            at = t

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        upto(a)
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    upto(t1)
    return segs


def span_table(tr) -> Optional[Dict[str, Dict[str, float]]]:
    """Per span name (and :data:`OUTSIDE`) the readings of the module
    docstring, seconds as floats; None without program spans or device
    activity. Kept on the trace, so that each metric of a run reads one
    sweep."""
    cached = getattr(tr, "_kmh_spans", None)
    if cached is not None:
        return cached or None
    t0, t1 = tr.t0, tr.t1
    spans = [(max(a, t0), min(b, t1), n) for a, b, n in tr.host
             if n.startswith(PREFIX) and b > t0 and a < t1]
    if not spans or not tr.device:
        tr._kmh_spans = {}
        return None
    busy = _Union(tr.busy)
    kernels = _Union(merge_intervals((a, b) for n, a, b in tr.device
                                     if not n.startswith(NOT_KERNELS)))
    launch_at = np.array(sorted(a for a, _b, n in tr.host
                                if n.startswith(LAUNCHES)), np.int64)
    out: Dict[str, Dict[str, float]] = {}

    def row(name: str) -> Dict[str, float]:
        return out.setdefault(name, {f: 0.0 if f.endswith("_s") else 0
                                     for f in FIELDS})

    def launches_in(x: np.ndarray, y: np.ndarray) -> int:
        return int((np.searchsorted(launch_at, y, side="left")
                    - np.searchsorted(launch_at, x, side="left")).sum())

    by_name: Dict[str, List[Tuple[int, int]]] = {}
    for a, b, n in spans:
        by_name.setdefault(n, []).append((a, b))
    for n, iv in by_name.items():
        m = merge_intervals(iv)
        x = np.array([a for a, _b in m], np.int64)
        y = np.array([b for _a, b in m], np.int64)
        r = row(n)
        r["n"] = len(iv)
        r["host_s"] = float((y - x).sum()) * 1e-9
        r["kernel_s"] = float(kernels.within(x, y).sum()) * 1e-9
        r["launches"] = launches_in(x, y)
    segs = _segments(spans, t0, t1)
    x = np.array([s[0] for s in segs], np.int64)
    y = np.array([s[1] for s in segs], np.int64)
    idle = (y - x) - busy.within(x, y)
    for (_a, _b, n), length, gap in zip(segs, (y - x).tolist(),
                                        idle.tolist()):
        r = row(n)
        r["self_s"] += length * 1e-9
        r["idle_s"] += gap * 1e-9
    outside = np.array([s[2] == OUTSIDE for s in segs], bool)
    r = row(OUTSIDE)
    r["host_s"] = r["self_s"]
    r["kernel_s"] = float(kernels.within(x[outside], y[outside]).sum()) * 1e-9
    r["launches"] = launches_in(x[outside], y[outside])
    tr._kmh_spans = out
    return out


def window_share(ctx, field: str, pick: Callable[[str], bool]
                 ) -> Optional[float]:
    """Per cent of the traced window: ``field`` summed over the names that
    ``pick`` takes. None where the table or every such name is missing."""
    tr = ctx.get("trace")
    t = span_table(tr) if tr is not None else None
    names = [n for n in t or () if pick(n)]
    if not names or tr.window_s <= 0:
        return None
    return 100.0 * sum(t[n][field] for n in names) / tr.window_s


def jobs_share(ctx, field: str, name: str) -> Optional[float]:
    """Per cent of the traced jobs' host seconds (``wall_s``): ``field`` of
    one span name."""
    tr = ctx.get("trace")
    t = span_table(tr) if tr is not None else None
    wall = sum(j["wall_s"] for j in ctx.get("trace_jobs") or [])
    if not t or name not in t or wall <= 0:
        return None
    return 100.0 * t[name][field] / wall
