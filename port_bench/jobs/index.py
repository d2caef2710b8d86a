"""``index``: ``make_kmer_hash`` of host bytes, ``kmer_pos(opt_flag)`` and,
with ``pairs``, the pair table streamed by ``iter_pair_chunks(
pair_capacity)``, all to the host.

Keys taken from the configuration: ``k`` and the sequence's
(:func:`gen.chromosome`). Keys taken from the traffic: ``opt_flag``,
``pairs``, ``pair_capacity``, ``warm_jobs`` (:meth:`Driver.warm`).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from port_bench import gen
from port_bench.drivers import Driver, rows_differing, sync


class Job(Driver):
    def setup(self) -> None:
        self.seq = gen.chromosome(self.cfg, self.seed, self.dev)
        self.warm()

    def job(self, i: int) -> Tuple[dict, object]:
        from kmer_hasher_tpu_torch import api

        k, flag = int(self.cfg["k"]), int(self.traffic["opt_flag"])
        t0 = time.perf_counter()
        ix = api.make_kmer_hash(self.seq, k, device=self.dev)
        sync(self.dev)  # the tables' span starts once the build is done
        t1 = time.perf_counter()
        tabs = api.kmer_pos(ix, flag)
        out = {name: (v if isinstance(v, list) else v.cpu().numpy())
               for name, v in tabs.items() if v is not None}
        if self.traffic["pairs"]:
            out["pair.pos"] = [c.cpu().numpy() for c in ix.iter_pair_chunks(
                int(self.traffic["pair_capacity"]))]
        sync(self.dev)
        t2 = time.perf_counter()
        del ix, tabs
        rec = {"bases": int(self.seq.shape[0]), "wall_s": t2 - t0,
               "tables_s": t2 - t1}
        return rec, out

    def names(self) -> List[str]:
        return ["pos", "count"] + (["pair.pos"] if self.traffic["pairs"]
                                   else [])

    def check(self, ref) -> List[dict]:
        r = ref.index_tables(self.seq, int(self.cfg["k"]), self.dev)
        worst: Dict[str, int] = {}
        for _i, out in self.sample.items():
            for name in self.names():
                if name != "pair.pos" and name not in out:
                    continue
                got = out[name]
                if name == "pair.pos":
                    got = (np.concatenate(got) if got
                           else np.zeros((0, 3), np.int32))
                d = rows_differing(np.asarray(got), r[name])
                worst[name] = max(worst.get(name, 0), d)
        return [{"name": f"{n.replace('.', '_')}_rows_differing",
                 "value": v, "limit": 0} for n, v in worst.items()]

    def broken(self, ref) -> List[Tuple[int, object]]:
        """Soft-masked bases read as N where the configuration states that
        case is ignored."""
        t = ref.index_tables(self.seq, int(self.cfg["k"]), self.dev,
                             soft_mask_as_n=True)
        t["pair.pos"] = [t["pair.pos"]]
        return [(0, t)]
