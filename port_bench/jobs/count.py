"""``count``: one read set counted into a fresh store, from reads staged in
host memory in the native reader's batch layout, through
``counting.count_batches``; the (key, count) table and the spectrum go to
the host.

Keys taken from the configuration: ``k``, ``min_q``, ``exact_ll``,
``prefix_bits``, ``max_count`` and the read set's (:func:`gen.read_batches`).
Keys taken from the traffic: ``warm_jobs`` (:meth:`Driver.warm`);
``store`` and ``count``, keyword arguments of
``CountStore`` and of ``count_batches`` passed through as they stand (a
store's ``spill_bytes``, for one), over the defaults set here.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from port_bench import gen
from port_bench.drivers import SIGN, Driver, sync, table_rows_differing


class Job(Driver):
    # the program's own float32 filter where the configuration states float64
    CONTROLS = {"f32": {"exact_ll": False}}

    def setup(self) -> None:
        self.batches = gen.read_batches(self.cfg, self.seed, self.dev)
        self.reads = sum(int(b[0].shape[0]) for b in self.batches)
        self.width = int(self.batches[0][0].shape[1])
        self.warm()

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
            "counts_n": 1, "prefix_bits": pb, "suffix_bits": sb, "mode": "sh",
            **self.traffic.get("store", {})})
        counting.count_batches(store, self.batches, k, stats=stats, **{
            "min_q": int(cfg["min_q"]), "exact_ll": cfg["exact_ll"],
            **self.traffic.get("count", {})})
        keys = store.keys.cpu().numpy()
        cnt = store.cnt.cpu().numpy()
        spec = api.kmer_spectrum(store, int(cfg["max_count"]))
        sync(self.dev)
        wall = time.perf_counter() - t0
        tm = {key: v for key, v in store.timings.items()
              if isinstance(v, (int, float))}
        rec = {"reads": self.reads, "wall_s": wall, "timings": tm,
               "flagged_reads": stats.get("flagged_reads"),
               "width": self.width,
               "b3_rows": cuda_merge.merge.rows - merge_rows,
               "distinct": int(keys.shape[0])}
        del store
        return rec, (keys, cnt, spec)

    def check(self, ref) -> List[dict]:
        cfg = self.cfg
        r_keys, r_cnt = ref.count_table(self.batches, cfg, self.dev)
        r_spec = ref.spectrum(r_cnt, int(cfg["max_count"]))
        rows = spec = 0
        for _i, (keys, cnt, s) in self.sample.items():
            raw = (keys ^ SIGN).view(np.uint64)
            rows = max(rows, table_rows_differing(raw, cnt[:, 0], r_keys,
                                                  r_cnt))
            spec = max(spec, int((np.asarray(s) != r_spec).sum()))
        return [{"name": "table_rows_differing", "value": rows, "limit": 0},
                {"name": "spectrum_bins_differing", "value": spec,
                 "limit": 0}]

    def broken(self, ref) -> List[Tuple[int, object]]:
        """Forward k-mers where the configuration states canonical ones."""
        cfg = self.cfg
        raw, cnt = ref.count_table(self.batches, cfg, self.dev,
                                   canonical=False)
        keys = raw.view(np.int64) ^ SIGN
        return [(0, (keys, cnt[:, None],
                     ref.spectrum(cnt, int(cfg["max_count"]))))]
