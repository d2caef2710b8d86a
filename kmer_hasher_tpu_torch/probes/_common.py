"""What every probe shares: a timer and the name of what was timed.

On a card a probe is timed with CUDA events around a run of calls after a
warm-up, and the median over a few such runs is kept. A call is the
wrapper's host work and its launch: at small sizes the former is what is
timed. A host clock with a readback, which the JAX probes used, times the
enqueue and the copy as well.
Without a card (``--device cpu``, the tests) the same function is timed on
the host's clock, once, and the line says so: such a number says nothing
about a device.
"""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch


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


WARMUP, REPEATS, ITERS = 2, 5, 10  # of a timing on a card


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
