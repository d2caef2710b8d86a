"""Structured progress metrics (PyTorch port of
``kmer_hasher_tpu/utils/metrics.py``).

The reference prints wall-clock progress every ``report_n`` reads — reads/s,
k-mer rates and the decoded most-common k-mer (src/kmer_hash.c:684-703,
779-798). This module is the structured equivalent: counters and rates with
pluggable sinks, plus the same most-common-k-mer sanity readout.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

_NUC = "ACTG"  # decode table, kmer_hash.c:21: code (c >> 1) & 3


@dataclass
class ProgressMeter:
    """Throughput meter emitting a structured record every ``report_every``
    units (reads, bases, k-mers...)."""

    name: str = "progress"
    report_every: int = 1_000_000
    sink: Optional[Callable[[Dict], None]] = None
    _t0: float = field(default_factory=time.perf_counter)
    _t_last: float = field(default_factory=time.perf_counter)
    _total: int = 0
    _last_report: int = 0
    _extra: Dict = field(default_factory=dict)

    def update(self, n: int, **extra) -> None:
        """Callable extras are evaluated lazily, only when a report is
        due — pass ``distinct_kmers=lambda: store.peek_n_unique()`` so the
        store is read once per report, not once per batch."""
        self._total += int(n)
        self._extra.update(extra)
        if self._total - self._last_report >= self.report_every:
            self.report()

    def report(self) -> Dict:
        now = time.perf_counter()
        window = self._total - self._last_report
        rec = {
            "name": self.name,
            "total": self._total,
            "rate": window / max(now - self._t_last, 1e-9),
            "avg_rate": self._total / max(now - self._t0, 1e-9),
            "elapsed_s": now - self._t0,
            **{k: (v() if callable(v) else v)
               for k, v in self._extra.items()},
        }
        self._last_report = self._total
        self._t_last = now
        (self.sink or _stderr_sink)(rec)
        return rec


def _stderr_sink(rec: Dict) -> None:
    print(json.dumps({k: _round(v) for k, v in rec.items()}),
          file=sys.stderr, flush=True)


def _round(v):
    return round(v, 3) if isinstance(v, float) else v


def decode_kmer(key: int, k: int) -> str:
    """Unsigned packed k-mer -> its bases, first base from the highest
    pair of bits (kmer_hash.c:123-133)."""
    return "".join(_NUC[(key >> (2 * (k - 1 - j))) & 3] for j in range(k))


def most_common_kmer(store) -> Dict:
    """The reference's progress-report sanity readout: the most common
    k-mer of source 0 and its count (src/kmer_hash.c:697-699). Batch
    counting has no stream order, so ties report the smallest key."""
    n = store.n_unique
    if n == 0:
        return {"kmer": None, "count": 0}
    col = store.cnt[:, 0]
    # the first row holding the maximum is the smallest key among the ties
    i = int((col == col.max()).nonzero()[0])
    # sortable int64 -> unsigned raw pattern: flip bit 63 of its 64 bits
    key = (int(store.keys[i]) & ((1 << 64) - 1)) ^ (1 << 63)
    return {"kmer": decode_kmer(key, store.k), "count": int(col[i])}
