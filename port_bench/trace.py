"""What a ``--trace 1`` run reads from ``torch.profiler``: the device's
activities (kernels, copies, fills) and the host's operations inside the
window, which the benchmark marks with a ``record_function`` span.

Busy time is the union of the device activities' intervals, each counted
once however they overlap; the window is the span's length. An idle gap is
an interval of the window with no device activity; it is named by the
innermost host operation under way at its middle.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "port_bench.window"
OUTER = (WINDOW, "port_bench.job")
GAPS_NAMED = 20000  # the longest gaps that are named by a host op
SCAN_BACK = 1000  # host events looked at, at most, to name one gap


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every recorded event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue  # a record_function range mirrored on the device
        start = int(e.start_ns())
        out.append((e.name(), on_device, start,
                    start + int(e.duration_ns())))
    return out


def merge_intervals(iv: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The window's device and host events, from a profiler, or from event
    tuples (name, is_device, start_ns, end_ns) in the tests."""

    def __init__(self, prof=None, events=None):
        events = _events(prof) if events is None else events
        spans = [(a, b) for name, dev, a, b in events
                 if not dev and name == WINDOW]
        if not spans:
            raise ValueError(f"no {WINDOW!r} span in the trace")
        self.t0, self.t1 = spans[0]
        self.device = []
        for name, dev, a, b in events:
            if dev and b > self.t0 and a < self.t1:
                self.device.append((name, max(a, self.t0), min(b, self.t1)))
        self.host = sorted((a, b, name) for name, dev, a, b in events
                           if not dev and b > self.t0 and a < self.t1)
        self._starts = [h[0] for h in self.host]
        self.busy = merge_intervals((a, b) for _n, a, b in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-9

    def device_s(self, patterns: Iterable[str]) -> float:
        """Seconds of the device activities whose name matches any of the
        regular expressions (each activity once)."""
        rx = [re.compile(p) for p in patterns]
        return sum(b - a for n, a, b in self.device
                   if any(r.search(n) for r in rx)) * 1e-9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.device:
            out[n] = out.get(n, 0.0) + (b - a) * 1e-9
        return out

    def gaps(self) -> List[Tuple[int, int]]:
        edges, at = [], self.t0
        for a, b in self.busy:
            if a > at:
                edges.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            edges.append((at, self.t1))
        return edges

    def _host_at(self, t: int) -> str:
        """The innermost host event under way at ``t`` (our own outer spans
        only where nothing else is)."""
        i = bisect.bisect_right(self._starts, t) - 1
        outer = None
        for a, b, name in reversed(self.host[max(0, i - SCAN_BACK): i + 1]):
            if a <= t < b:
                if name not in OUTER:
                    return name
                if outer is None or name == OUTER[1]:  # the job, not the window
                    outer = name
        return outer or "(no host event)"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:GAPS_NAMED]
        named: Dict[str, float] = {}
        for a, b in gaps:
            n = self._host_at((a + b) // 2)
            named[n] = named.get(n, 0.0) + (b - a) * 1e-9
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[_short(n), s] for n, s in idle]}


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def idle_share(ctx) -> Optional[float]:
    """Per cent of the traced window with no device activity."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
