"""What every job kind shares, and the kinds found by name.

A traffic file's ``kind`` names the file ``jobs/<kind>.py``, which holds a
``Job``: a subclass of :class:`Driver` that makes its inputs from the seed
(:mod:`port_bench.gen`), runs its warm jobs in set-up, then runs whole jobs
for the window. A job is one user's whole task through
``kmer_hasher_tpu_torch``'s public entries and ends with its results copied
to host memory. Every job returns a record of what it did (the work done,
its host seconds, the program's own counters) for the metric readers, and
its host outputs. A sample of the outputs, drawn from the seed, is kept,
and :meth:`Driver.check` holds it against the configuration's plain
reference (``reference/<config>.py``) once the window has closed.

A kind also says how its controls are made (``CONTROLS``, configuration
keys that put the program's lower precision in its place, and
:meth:`Driver.broken`, the reference with a stated guarantee broken).
A new kind is a new file; the keys of its traffic and configuration files
are its own.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from . import gen

JOBS = Path(__file__).resolve().parent / "jobs"
SIGN = np.int64(-(2 ** 63))  # the store's sortable keys: raw pattern ^ SIGN


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rows_differing(a: np.ndarray, b: np.ndarray) -> int:
    """Rows of two tables that differ position by position, a row that
    only one of them has counting as differing."""
    n = min(a.shape[0], b.shape[0])
    diff = abs(a.shape[0] - b.shape[0])
    if n:
        d = a[:n] != b[:n]
        diff += int((d.reshape(n, -1).any(axis=1)).sum())
    return diff


def table_rows_differing(keys_a, cnt_a, keys_b, cnt_b) -> int:
    """(key, count) rows in one sorted unique table and not the other."""
    if (keys_a.shape == keys_b.shape and np.array_equal(keys_a, keys_b)
            and np.array_equal(cnt_a, cnt_b)):
        return 0
    _common, ia, ib = np.intersect1d(keys_a, keys_b, assume_unique=True,
                                     return_indices=True)
    only = keys_a.shape[0] + keys_b.shape[0] - 2 * ia.shape[0]
    return int(only + (cnt_a[ia] != cnt_b[ib]).sum())


class Sample:
    """The outputs kept for the check: the window's first job and one more
    drawn from the seed by reservoir sampling over the later jobs (job i
    replaces the kept one with odds 1/i), so that any job of the window
    can be the one compared."""

    def __init__(self, seed: int, extra: int = 1):
        self.rng = np.random.default_rng(gen.subseed(seed, "check_sample"))
        self.extra = extra
        self.first = None
        self.kept: Dict[int, object] = {}

    def offer(self, i: int, out) -> None:
        if i == 0:
            self.first = out
            return
        if len(self.kept) < self.extra:
            self.kept[i] = out
            return
        if self.rng.random() < self.extra / i:
            self.kept.pop(next(iter(self.kept)))
            self.kept[i] = out

    def items(self) -> List[Tuple[int, object]]:
        head = [] if self.first is None else [(0, self.first)]
        return head + sorted(self.kept.items())


class Fixed:
    """A sample that holds the items it is given (a control's outputs)."""

    def __init__(self, items: List[Tuple[int, object]]):
        self._items = list(items)

    def items(self) -> List[Tuple[int, object]]:
        return self._items


class Driver:
    """What every kind shares: the configuration, the traffic, the seed and
    the device; ``setup``, ``job``, ``release``, ``check`` and ``broken``.

    ``CONTROLS`` maps a control's name to the configuration keys that switch
    the program's own lower-precision path on, where it has one."""

    CONTROLS: Dict[str, dict] = {}

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 dev: torch.device):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        self.sample = self.new_sample()
        self._cleanup: List[Callable[[], None]] = []

    def new_sample(self):
        return Sample(self.seed)

    def setup(self) -> None:
        raise NotImplementedError

    def job(self, i: int) -> Tuple[dict, object]:
        raise NotImplementedError

    def warm(self) -> None:
        """The set-up's warm jobs: the traffic's ``warm_jobs`` (one where it
        names none), run until the host's and the device's allocators
        serve a job from what earlier jobs left them."""
        for _ in range(int(self.traffic.get("warm_jobs", 1))):
            self.job(-1)

    def control_jobs(self) -> range:
        """The jobs a control reading runs after set-up."""
        return range(1)

    def offer(self, i: int, out) -> None:
        self.sample.offer(i, out)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, ref) -> List[dict]:
        raise NotImplementedError

    def broken(self, ref) -> List[Tuple[int, object]]:
        """The reference with one stated guarantee broken, as the kept
        sample's items (job, outputs) would hold it: the control where the
        program has no lower precision of its own."""
        raise NotImplementedError

    def close(self) -> None:
        while self._cleanup:
            self._cleanup.pop()()


def make(cfg: dict, traffic: dict, seed: int, dev: torch.device) -> Driver:
    """``Job`` of ``jobs/<kind>.py``, the traffic's ``kind``."""
    from .run import load_module

    path = JOBS / f"{traffic['kind']}.py"
    if not path.is_file():
        raise ValueError(f"no job kind {traffic['kind']!r} ({path.name})")
    return load_module(path, "port_bench.jobs").Job(cfg, traffic, seed, dev)
