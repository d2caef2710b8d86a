"""The benchmark's files keep to its contract, and every cell runs at a tiny
size on the CPU and prints a result line of the agreed form."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import types

import pytest

from conftest import CELLS, ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32
    assert all(LINE.match(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert b["paths"] == ["port_bench"]
    assert not b["paths"][0].endswith("_torch")
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fit_the_check_with_24_cells():
    rs = bench()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith("port_bench/configs/")
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"])


def test_bounds():
    e2e = {m["name"]: m for m in bench()["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


def test_every_piece_is_found_by_name():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(
        b["workloads"])
    for w in b["workloads"]:
        t = json.loads((ROOT / "port_bench" / "traffic"
                        / f"{w['traffic']}.json").read_text())
        assert (ROOT / "port_bench" / "jobs" / f"{t['kind']}.py").is_file()
        assert (ROOT / "port_bench" / "tests" / "faults"
                / f"{t['kind']}.py").is_file()
        assert (ROOT / "port_bench" / "reference"
                / f"{w['config']}.py").is_file()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_reports_enough():
    from port_bench import run

    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(b, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert run.cell_metrics(b, w, True), w["name"]
        for m in run.cell_metrics(b, w, True):
            assert m["moves"] in e2e


def test_four_chip_cells_at_most_a_quarter():
    cells = bench()["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_prints_the_result_line(tiny_run, workload, trace):
    rc, last, _out, err = tiny_run(workload, trace)
    assert rc == 0, err
    assert last is not None
    keys = list(last)
    assert tuple(keys[:5]) == RESULT_KEYS
    assert keys[-1] == "checks"
    assert set(keys) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert ("breakdown" in keys) == bool(trace)
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    dev = last["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            assert len(last["breakdown"][part]) <= 10
    b = bench()
    from port_bench import run

    cell = {w["name"]: w for w in b["workloads"]}[workload]
    allowed = {m["name"]: m["unit"]
               for m in run.cell_metrics(b, cell, bool(trace))}
    assert set(last["metrics"]) <= set(allowed)
    for name, m in last["metrics"].items():
        assert m["unit"] == allowed[name]
    if not trace:
        assert "setup_s" in last["metrics"]
    for name, c in last["checks"].items():
        assert NAME.match(name) and c["value"] <= c["limit"]
        assert f"check {name} {c['value']} limit {c['limit']}" in err


def test_a_measured_run_without_a_card_prints_nothing(tiny_run):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    rc, last, out, err = tiny_run(CELLS[0], device="cuda")
    assert rc != 0 and last is None and out.strip() == ""
    assert "cuda" in err


def test_jax_loaded_in_the_process_fails_the_run(tiny_run, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, last, out, err = tiny_run("chr21_k32.selfplot")
    assert rc != 0 and last is None and out.strip() == ""
    assert "jax" in err


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    from port_bench import run

    for name in ("kmer_hasher_tpu_torch", "kmer_hasher_tpu_torch.api",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.banned_modules() == []
    for name in ("kmer_hasher_tpu.api", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.banned_modules() == ["flax.linen", "jaxlib",
                                    "kmer_hasher_tpu.api"]


def test_a_checkout_of_the_benchmark_alone_prints_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "chr21_k32.selfplot", "--seed", "1", "--seconds", "1", "--trace",
         "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_count_traffic_passes_store_keys_through():
    """A store option is data: ``store`` of a count traffic file reaches
    ``CountStore`` (here a spill budget small enough to spill every run
    to host memory), and the job stays correct."""
    import torch

    from port_bench import drivers
    from port_bench.run import HERE, load_module
    from conftest import files, tiny

    w = "wgs151_k21.staged"
    cfg, traffic = files(w)
    cfg = {**cfg, **tiny(w)["config"]}
    traffic = {**traffic, "store": {"spill_bytes": 4096}}
    drv = drivers.make(cfg, traffic, 2_147_483_719, torch.device("cpu"))
    try:
        drv.setup()
        rec, out = drv.job(0)
        drv.offer(0, out)
        drv.release()
        checks = drv.check(load_module(HERE / "reference" / "wgs151_k21.py",
                                       "port_bench.reference"))
    finally:
        drv.close()
    assert rec["timings"]["spills"] > 0
    assert all(c["value"] == 0 for c in checks)
