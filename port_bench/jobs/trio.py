"""``trio``: a parent-child trio's three read sets counted into one fresh
three-source store, source by source, from reads staged in host memory in
the native reader's batch layout; then the combination spectra and the
child's depth tracks. The (key, 3 counts) table, the spectra and the
tracks go to the host.

One job, in order: ``CountStore(k, counts_n=sources, mode="sh")`` with the
traffic's ``store`` keywords; ``counting.count_batches`` of the child's,
the mother's and the father's batches with ``source`` 0, 1, 2; the table
to the host; ``api.kmer_spectrum_n`` over the traffic's ``spectrum_n``
combinations with the configuration's ``source_min``; ``seq_kmer_depth``
along each of the child's two haplotypes, each ``[3, L]`` to the host.

Keys taken from the configuration: ``k``, ``min_q``, ``exact_ll``,
``prefix_bits``, ``max_count``, ``sources``, ``source_min`` and the trio's
(:mod:`port_bench.gen_trio`). Keys taken from the traffic: ``warm_jobs``,
``spectrum_n`` (``comb``, ``comb_inner``), and ``store`` and ``count``,
keyword arguments of ``CountStore`` and ``count_batches`` passed through as
they stand. The job's record carries the ``count`` kind's keys, so the
count path's metrics read it unchanged, and the store's ``total_added``
per source.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from port_bench import gen_trio
from port_bench.drivers import SIGN, Driver, sync, table_rows_differing


def whole_rows(cnt: np.ndarray) -> np.ndarray:
    """[n, S] count rows as n opaque items, so that a row compares whole."""
    cnt = np.ascontiguousarray(cnt)
    return cnt.view(np.dtype((np.void, cnt.shape[1] * cnt.itemsize)))[:, 0]


def positions_differing(a: np.ndarray, b: np.ndarray) -> int:
    """Columns of two [S, L] tracks that differ in any row."""
    if a.shape != b.shape:
        return max(a.shape[1], b.shape[1])
    return int((a != b).any(axis=0).sum())


class Job(Driver):
    # the program's own float32 filter where the configuration states float64
    CONTROLS = {"f32": {"exact_ll": False}}

    def setup(self) -> None:
        self.sources, self.child = gen_trio.trio(self.cfg, self.seed,
                                                 self.dev)
        self.reads = sum(int(b[0].shape[0]) for batches in self.sources
                         for b in batches)
        self.width = int(self.sources[0][0][0].shape[1])
        self.warm()

    def _spectrum_args(self) -> tuple:
        sp = self.traffic["spectrum_n"]
        return (int(self.cfg["max_count"]), sp["comb"], sp["comb_inner"],
                self.cfg["source_min"])

    def job(self, i: int) -> Tuple[dict, object]:
        from kmer_hasher_tpu_torch import api, counting
        from kmer_hasher_tpu_torch.ops import cuda_merge

        cfg = self.cfg
        k = int(cfg["k"])
        merge_rows = cuda_merge.merge.rows
        stats: dict = {}
        t0 = time.perf_counter()
        pb, sb = counting.derive_prefix_suffix_bits(k, cfg["prefix_bits"])
        store = api.CountStore(k, device=self.dev, **{
            "counts_n": int(cfg["sources"]), "prefix_bits": pb,
            "suffix_bits": sb, "mode": "sh",
            **self.traffic.get("store", {})})
        for source, batches in enumerate(self.sources):
            counting.count_batches(store, batches, k, source=source,
                                   stats=stats, **{
                                       "min_q": int(cfg["min_q"]),
                                       "exact_ll": cfg["exact_ll"],
                                       **self.traffic.get("count", {})})
        keys = store.keys.cpu().numpy()
        cnt = store.cnt.cpu().numpy()
        spec = api.kmer_spectrum_n(store, *self._spectrum_args())
        tracks = [api.seq_kmer_depth(store, hap, k).cpu().numpy()
                  for hap in self.child]
        sync(self.dev)
        wall = time.perf_counter() - t0
        tm = {key: v for key, v in store.timings.items()
              if isinstance(v, (int, float))}
        rec = {"reads": self.reads, "wall_s": wall, "timings": tm,
               "flagged_reads": stats.get("flagged_reads"),
               "width": self.width,
               "b3_rows": cuda_merge.merge.rows - merge_rows,
               "distinct": int(keys.shape[0]),
               "total_added": store.total_added.tolist()}
        del store
        return rec, (keys, cnt, spec, tracks)

    def _reference(self, ref, summed: bool = False) -> tuple:
        """The reference's (raw keys, counts, spectra, tracks); with
        ``summed`` the sources' counts in one column."""
        raw, cnt = ref.count_table(self.sources, self.cfg, self.dev)
        if summed:
            cnt = ref.sources_summed(cnt)
        spec = ref.spectrum_n(cnt, *self._spectrum_args())
        k = int(self.cfg["k"])
        tracks = [ref.depth(raw, cnt, hap, k, self.dev)
                  for hap in self.child]
        return raw, cnt, spec, tracks

    def check(self, ref) -> List[dict]:
        r_raw, r_cnt, r_spec, r_tracks = self._reference(ref)
        rows = spec = depth = 0
        for _i, (keys, cnt, s, tracks) in self.sample.items():
            raw = (keys ^ SIGN).view(np.uint64)
            rows = max(rows, table_rows_differing(
                raw, whole_rows(cnt), r_raw, whole_rows(r_cnt)))
            spec = max(spec, int((np.asarray(s) != r_spec).sum()))
            depth = max(depth, sum(positions_differing(t, r)
                                   for t, r in zip(tracks, r_tracks)))
        return [{"name": "table_rows_differing", "value": rows, "limit": 0},
                {"name": "spectrum_n_bins_differing", "value": spec,
                 "limit": 0},
                {"name": "depth_positions_differing", "value": depth,
                 "limit": 0}]

    def broken(self, ref) -> List[Tuple[int, object]]:
        """The three sources summed into one column where the configuration
        states per-source counts."""
        raw, cnt, spec, tracks = self._reference(ref, summed=True)
        keys = raw.view(np.int64) ^ SIGN
        return [(0, (keys, cnt, spec, tracks))]
