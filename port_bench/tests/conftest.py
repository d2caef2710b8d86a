"""Shared pieces of the benchmark's own CPU tests: every cell at a tiny size
(``--device cpu``), through the same code as a run on the card. A cell's
tiny size is the ``tiny`` block of its configuration and traffic files; a
job kind's faults are ``faults/<kind>.py``."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


CELLS = sorted(w["name"] for w in bench()["workloads"])


def files(workload: str):
    """(configuration, traffic) of a cell, as its files hold them."""
    from port_bench.run import load_cell

    _b, _cell, cfg, traffic = load_cell(workload)
    return cfg, traffic


def tiny(workload: str) -> dict:
    """The overrides that make a cell tiny: its files' ``tiny`` blocks."""
    cfg, traffic = files(workload)
    return {"config": cfg.get("tiny", {}), "traffic": traffic.get("tiny", {})}


def kind(workload: str) -> str:
    return files(workload)[1]["kind"]


def faults(job_kind: str) -> list:
    """``FAULTS`` of ``faults/<kind>.py``: functions that break the timed
    path underneath, each given pytest's ``monkeypatch``."""
    path = Path(__file__).with_name("faults") / f"{job_kind}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_faults_{job_kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAULTS


@pytest.fixture
def tiny_run(capsys):
    """Run one cell at its tiny size on the CPU through ``run.main``;
    returns (exit code, the parsed last line of standard output or None,
    standard output, standard error)."""
    from port_bench import run

    def go(workload: str, trace: int = 0, seed: int = 2_147_483_711,
           device: str = "cpu"):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.3", "--trace", str(trace),
                       "--device", device], overrides=tiny(workload))
        out, err = capsys.readouterr()
        lines = [x for x in out.splitlines() if x.strip()]
        last = None
        if lines:
            try:
                last = json.loads(lines[-1])
            except json.JSONDecodeError:
                last = None
        return rc, last, out, err

    return go
