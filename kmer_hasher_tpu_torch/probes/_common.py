"""What every probe shares: timers and the name of what was timed.

On a card a probe is timed with CUDA events around a run of calls after a
warm-up, and the median over a few such runs is kept. A call is the
wrapper's host work and its launch: at small sizes the former is what is
timed. A host clock with a readback, which the JAX probes used, times the
enqueue and the copy as well.
Without a card (``--device cpu``, the tests) the same function is timed on
the host's clock, once, and the line says so: such a number says nothing
about a device.

To tell the two apart, :func:`device_ms` sums what a call ran on the card
(``torch.profiler``'s kernel, copy and fill durations) and :func:`host_us`
clocks the host's work per call without a synchronisation;
:func:`in_turns` times several functions in turns by both, so that two
versions are compared within one process on one card.

:func:`lex_sort` is the plain two-key row sort the sort probes time and
the merge kernel's checks build their sorted runs with.
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import torch


def unsigned_pay(pay: torch.Tensor) -> torch.Tensor:
    """An int32 payload lane as int64 values in [0, 2^32)."""
    return pay.to(torch.int64) & 0xFFFFFFFF


def lex_sort(key: torch.Tensor, pay: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (int64 key, int32 payload) lexicographically along the last
    axis, the payload compared as unsigned: a stable LSD pair of
    ``torch.sort`` passes, payload first, then key."""
    by_pay = torch.sort(unsigned_pay(pay), dim=-1, stable=True).indices
    s_key, order = torch.sort(key.gather(-1, by_pay), dim=-1, stable=True)
    return s_key, pay.gather(-1, by_pay.gather(-1, order))


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, to
    stand beside every number; for the CPU, a label that says the times are
    the host clock's."""
    if dev.type != "cuda":
        return "cpu, host clock (not a device time)"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def sync(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (a no-op on the CPU): what a
    host clock around device work must end with."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_time(fn: Callable[[], object], dev: torch.device, iters: int = 3):
    """(the best host seconds of ``iters`` calls of ``fn``, each ended by a
    :func:`sync`, after one such call as a warm-up; the last call's
    result): the user scripts' best-of timing, as their JAX sources take
    it."""
    def once():
        out = fn()
        sync(dev)
        return out

    once()
    best, out = float("inf"), None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = once()
        best = min(best, time.perf_counter() - t0)
    return best, out


WARMUP, REPEATS, ITERS = 2, 5, 10  # of a timing on a card
PROFILE_WINDOWS = 3  # profiler windows of which device_ms takes the median


def timeit(fn: Callable[[], object], dev: torch.device, iters: int = ITERS
           ) -> float:
    """Seconds per call of ``fn``. On a card: WARMUP calls, then REPEATS
    runs of ``iters`` calls each between two CUDA events, the median run
    over ``iters``. On the CPU: one call on the host's clock."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    for _ in range(WARMUP):
        fn()
    runs = []
    with torch.cuda.device(dev):
        for _ in range(REPEATS):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(iters):
                fn()
            t1.record()
            t1.synchronize()
            runs.append(t0.elapsed_time(t1) / iters * 1e-3)
    return statistics.median(runs)


def time_once(fn: Callable[[], object], dev: torch.device):
    """(``fn()``, the seconds of that one call): CUDA events around it on a
    card, the host clock on the CPU. For plain versions, whose time is no
    yardstick and can be long: the check's own call is the one timed."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    with torch.cuda.device(dev):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = fn()
        t1.record()
        t1.synchronize()
    return out, t0.elapsed_time(t1) * 1e-3


def calls_per_timing(dev: torch.device, iters: int = ITERS) -> int:
    """How many times :func:`timeit` calls its function."""
    return 1 if dev.type != "cuda" else WARMUP + REPEATS * iters


def events_ms(fn: Callable[[], object], iters: int) -> float:
    """Milliseconds per call of ``fn`` between two CUDA events around
    ``iters`` calls back to back: the device's time where it is busy, the
    host's where a call's host work outlasts its kernels."""
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_profile(fn: Callable[[], object], iters: int) -> dict:
    """What ``iters`` calls of ``fn`` put on the card, from the kernel,
    copy and fill durations that ``torch.profiler`` records: name ->
    (activities per call, milliseconds per call). Empty where the trace
    holds no device time.

    In a process that has traced many windows, the profiler can lose the
    records of a call or two of a window (seen on an H100: 8 of 10 calls
    recorded). A call of ``fn`` runs the same activities every time, so
    each name's count per call is taken as the nearest whole number and
    its time as that many times the mean of the records kept; a name seen
    in fewer than half the calls is not ``fn``'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    out = {}
    for name, (n, us) in by_name.items():
        per_call = round(n / iters)
        if per_call:
            out[name] = (per_call, us * 1e-3 / n * per_call)
    return out


def device_ms(fn: Callable[[], object], iters: int) -> Optional[float]:
    """Device milliseconds per call of ``fn``: the summed durations of
    everything its calls ran on the card (:func:`device_profile`), whatever
    the host took to launch them; the median over PROFILE_WINDOWS profiler
    windows, since in a long process a window can come back empty or short
    of records; None where every trace holds no device time."""
    totals = [t for t in (_total_ms(device_profile(fn, iters))
                          for _ in range(PROFILE_WINDOWS)) if t is not None]
    return statistics.median(totals) if totals else None


def _total_ms(prof: dict) -> Optional[float]:
    """The summed milliseconds of a :func:`device_profile`, or None."""
    return sum(ms for _, ms in prof.values()) if prof else None


def host_us(fn: Callable[[], object], iters: int) -> float:
    """Host microseconds per call of ``fn``: the host's clock around
    ``min(iters, 20)`` calls with no synchronisation, so the wrapper's own
    work and its launches, not the kernels; the median of REPEATS runs.
    (Few calls, so that the launch queue never fills and makes the host
    wait for the card.)"""
    n = min(iters, 20)
    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def in_turns(fns: Dict[str, Callable[[], object]], iters: int,
             pairs: int = 5, device_pairs: int = 3) -> dict:
    """The functions of ``fns`` timed in turns on the card, after a warm-up
    of each: the order forward then backward (a b b a for two), ``pairs``
    times by CUDA events (:func:`events_ms` over ``iters`` calls) and
    ``device_pairs`` times by device time (:func:`device_profile`). Returns
    name -> {"ms", "device_ms": medians, "ms_turns", "device_ms_turns":
    every turn, "host_us_per_call", "activities": what the calls of the last
    device turn ran on the card}."""
    names = list(fns)
    for name in names:
        for _ in range(WARMUP):
            fns[name]()
    order = names + names[::-1]
    out = {n: {"ms_turns": [], "device_ms_turns": []} for n in names}
    for _ in range(pairs):
        for n in order:
            out[n]["ms_turns"].append(events_ms(fns[n], iters))
    for _ in range(device_pairs):
        for n in order:
            prof = out[n]["activities"] = device_profile(fns[n], iters)
            out[n]["device_ms_turns"].append(_total_ms(prof))
    for n in names:
        row = out[n]
        row["ms"] = statistics.median(row["ms_turns"])
        dev = [t for t in row["device_ms_turns"] if t is not None]
        row["device_ms"] = statistics.median(dev) if dev else None
        row["host_us_per_call"] = host_us(fns[n], iters)
    return out
