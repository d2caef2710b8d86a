"""``query``: one client's closed loop of ``seq_kmer_pos`` over an index
built in set-up, through a pool of query segments made from the seed
(:func:`gen.query_pool`); a job is one query, its hits to the host.

Keys taken from the configuration: ``k`` and the sequence's
(:func:`gen.chromosome`). Keys taken from the traffic: the pool's
(``pool``, ``strata``, ``min_len``, ``max_len``, ``sub_rate``) and
``check_queries``, the pool entries compared besides the longest.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from port_bench import gen
from port_bench.drivers import Driver, rows_differing, sync


class Job(Driver):
    def new_sample(self):
        return QuerySample(self.seed, int(self.traffic["check_queries"]))

    def setup(self) -> None:
        from kmer_hasher_tpu_torch import api

        self.seq = gen.chromosome(self.cfg, self.seed, self.dev)
        self.pool = gen.query_pool(self.seq, self.traffic, self.seed,
                                   self.dev)
        self.index = api.make_kmer_hash(self.seq, int(self.cfg["k"]),
                                        device=self.dev)
        for j in range(int(self.traffic["strata"])):  # one of each stratum
            self.job(j)

    def control_jobs(self) -> range:
        return range(len(self.pool))

    def job(self, i: int) -> Tuple[dict, object]:
        from kmer_hasher_tpu_torch import api

        p = i % len(self.pool)
        q = self.pool[p]
        t0 = time.perf_counter()
        hits = api.seq_kmer_pos(self.index, q, int(self.cfg["k"]))
        h = hits.cpu().numpy()
        sync(self.dev)
        lat = time.perf_counter() - t0
        return {"bases": int(q.shape[0]), "wall_s": lat, "latency_s": lat,
                "hits": int(h.shape[0])}, (p, h)

    def release(self) -> None:
        self.index = None
        super().release()

    def check(self, ref) -> List[dict]:
        picked = self.sample.items()
        want = ref.query_hits(self.seq, [self.pool[p] for p, _h in picked],
                              int(self.cfg["k"]), self.dev)
        diff = sum(rows_differing(h, w) for (_p, h), w in zip(picked, want))
        return [{"name": "hit_rows_differing", "value": diff, "limit": 0}]

    def broken(self, ref) -> List[Tuple[int, object]]:
        """Soft-masked bases read as N where the configuration states that
        case is ignored, for the kept sample's queries."""
        picked = [p for p, _h in self.sample.items()]
        hits = ref.query_hits(self.seq, [self.pool[p] for p in picked],
                              int(self.cfg["k"]), self.dev,
                              soft_mask_as_n=True)
        return list(zip(picked, hits))


class QuerySample:
    """The queries kept for the check: ``n`` pool entries drawn from the
    seed by reservoir sampling among those the window ran (each entry's
    first run), and the longest entry it ran."""

    def __init__(self, seed: int, n: int):
        self.rng = np.random.default_rng(gen.subseed(seed, "check_queries"))
        self.n = n
        self.seen: set = set()
        self.kept: Dict[int, np.ndarray] = {}
        self.longest: Optional[Tuple[int, int, np.ndarray]] = None

    def offer(self, i: int, out) -> None:
        p, h = out
        if p in self.seen:
            return
        self.seen.add(p)
        if self.longest is None or h.shape[0] > self.longest[0]:
            self.longest = (int(h.shape[0]), p, h)
        if len(self.kept) < self.n:
            self.kept[p] = h
        elif self.rng.random() < self.n / len(self.seen):
            self.kept.pop(sorted(self.kept)[int(self.rng.integers(self.n))])
            self.kept[p] = h

    def items(self) -> List[Tuple[int, np.ndarray]]:
        kept = dict(self.kept)
        if self.longest is not None:
            kept[self.longest[1]] = self.longest[2]
        return sorted(kept.items())
