"""The controls of the comparison that decides ``correct``, at a cell's own
size, on the seeds given: the readings from which the limits are set.

    python3 -m port_bench.control --workload <name> --seeds <n> [<n> ...]
                                  [--device cuda|cpu]

For each seed it makes the cell's inputs, runs one job of the program and
holds it against the plain reference (the lower reading), then puts in the
program's place each control that the cell can have and holds that
against the reference too:

- the program's own lower precision, where it has one: each entry of the
  job kind's ``CONTROLS`` (configuration keys that switch that path on;
  for ``count``, ``f32``: the likelihood filter in float32 where the
  configuration states float64);
- ``guarantee``: the reference with one guarantee of the configuration
  broken (the kind's ``Driver.broken``): forward k-mers where it states
  canonical ones (counting), soft-masked bases read as N where it states
  that case is ignored (index and queries).

Prints one JSON line per seed and control with the numbers compared. The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from . import drivers
from .run import HERE, check_device, load_cell, load_module


def readings(workload: str, seed: int, device: str,
             overrides: dict = None, bench: dict = None) -> List[dict]:
    """The readings of one seed; ``overrides`` and ``bench`` as
    ``run.main`` takes them."""
    bench, cell, cfg, traffic = load_cell(workload, bench)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    dev = check_device(device, int(cell["chips"]))
    ref = load_module(HERE / "reference" / f"{cell['config']}.py",
                      "port_bench.reference")
    out = []
    kinds = drivers.make(cfg, traffic, seed, dev).CONTROLS
    variants = [("program", cfg)] + [(name, {**cfg, **keys})
                                     for name, keys in kinds.items()]
    for name, c in variants:
        drv = drivers.make(c, traffic, seed, dev)
        try:
            drv.setup()
            for i in drv.control_jobs():
                _rec, o = drv.job(i)
                drv.offer(i, o)
            drv.release()
            out.append({"workload": workload, "seed": seed, "control": name,
                        "checks": {x["name"]: x["value"]
                                   for x in drv.check(ref)}})
            if name == "program":
                drv.sample = drivers.Fixed(drv.broken(ref))
                out.append({"workload": workload, "seed": seed,
                            "control": "guarantee",
                            "checks": {x["name"]: x["value"]
                                       for x in drv.check(ref)}})
        finally:
            drv.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        for r in readings(args.workload, seed, args.device):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
