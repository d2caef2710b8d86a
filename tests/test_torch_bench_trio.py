"""The benchmark's trio cell, ``trio_wgs151_k21.hapmers``, at its tiny size
on the CPU through ``port_bench``: correct, with every job spilling and
folding by key range; the guarantee control (the three sources summed into
one column) and a planted fault in the per-source columns reported as not
correct. Then its three new per-layer metrics on records and traces whose
every number is known, and its configuration against
``human_wgs151_k21``'s.

``port_bench.run`` is imported inside a fixture, never while this module is
imported: importing it sets the process's allocator options
(``run.keep_freed_memory``)."""
import importlib.util
import json

import pytest
import torch

CELL = "trio_wgs151_k21.hapmers"
SEED = 4_294_967_311
# the count path's metrics, read on this cell too, then its own
SHARED = ("tier_merge_share", "scan_roofline", "merge_roofline",
          "idle_share.count", "stage_idle_share", "batch_idle_share",
          "tier_merge_device_share", "idle_outside_program.count",
          "spill_share", "rejoin_share", "staging_link_share",
          "spill_idle_share")
OWN = ("spectrum_n_share", "depth_share", "hapmer_idle_share")
DEVICE = {"scan_roofline", "merge_roofline", "idle_share.count",
          "stage_idle_share", "batch_idle_share", "tier_merge_device_share",
          "idle_outside_program.count", "staging_link_share",
          "spill_idle_share", "hapmer_idle_share"}


@pytest.fixture
def bench_run():
    from port_bench import run

    return run


def tiny(bench_run) -> dict:
    _b, _cell, cfg, traffic = bench_run.load_cell(CELL)
    return {"config": cfg["tiny"], "traffic": traffic["tiny"]}


def metric(bench_run, name: str):
    return bench_run.load_module(bench_run.HERE / "metrics" / f"{name}.py")


def run_tiny(bench_run, trace: int, monkeypatch, capsys):
    """The cell at its tiny size on the CPU: the result line and the
    window jobs' records."""
    jobs = []
    real = bench_run.window

    def window(*a, **k):
        out = real(*a, **k)
        jobs.extend(out[0])
        return out

    monkeypatch.setattr(bench_run, "window", window)
    # the suite's conftest loads JAX for its comparisons: the run may load
    # none of it beyond what is there already
    before = set(bench_run.banned_modules())
    banned = bench_run.banned_modules
    monkeypatch.setattr(bench_run, "banned_modules",
                        lambda: [n for n in banned() if n not in before])
    rc = bench_run.main(["--workload", CELL, "--seed", str(SEED),
                         "--seconds", "0.3", "--trace", str(trace),
                         "--device", "cpu"], overrides=tiny(bench_run))
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), jobs


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct_and_every_job_spills_and_folds_by_range(
        bench_run, trace, monkeypatch, capsys):
    last, jobs = run_tiny(bench_run, trace, monkeypatch, capsys)
    assert last["correct"] is True and last["failed"] == 0
    assert set(last["checks"]) == {"table_rows_differing",
                                   "spectrum_n_bins_differing",
                                   "depth_positions_differing"}
    assert all(c["value"] == 0 for c in last["checks"].values())
    assert jobs
    _b, _cell, cfg, _t = bench_run.load_cell(CELL)
    genome = cfg["tiny"]["genome_len"]
    for j in jobs:
        tm = j["timings"]
        assert tm["spills"] >= 3
        assert tm["ranged_folds"] == 3 and tm["ranges"] >= 6  # one a source
        assert tm["rejoined_rows"] == tm["spilled_rows"] > 0
        assert tm["spectrum_n_s"] > 0 and tm["depth_s"] > 0
        assert tm["depth_windows"] == 2 * (genome - 21 + 1)
        assert len(j["total_added"]) == 3 and min(j["total_added"]) > 0
        assert j["reads"] == 3 * 2 * 300 and j["distinct"] > 0
    got = last["metrics"]
    if trace:
        for name in ("spill_share", "rejoin_share", "spectrum_n_share",
                     "depth_share"):
            assert got[name]["value"] > 0, name
        assert "tier_merge_share" in got  # every run spills unmerged here
        # the CPU stages nothing and has no device activity
        assert not DEVICE & set(got)
    else:
        assert {"count_reads_per_s", "setup_s"} <= set(got)


def test_sources_summed_into_one_column_is_not_correct(bench_run):
    """The guarantee control: the reference with the three sources' counts
    in one column fails every check of the cell."""
    from port_bench import drivers

    b = tiny(bench_run)
    _bench, _cell, cfg, traffic = bench_run.load_cell(CELL)
    drv = drivers.make({**cfg, **b["config"]},
                       {**traffic, **b["traffic"], "warm_jobs": 0}, SEED,
                       torch.device("cpu"))
    ref = bench_run.load_module(bench_run.HERE / "reference"
                                / "trio_wgs151_k21.py",
                                "port_bench.reference")
    try:
        drv.setup()
        drv.sample = drivers.Fixed(drv.broken(ref))
        checks = {c["name"]: c for c in drv.check(ref)}
    finally:
        drv.close()
    assert len(checks) == 3
    for c in checks.values():
        assert c["value"] > c["limit"], c


def test_the_planted_per_source_fault_is_not_correct(bench_run, monkeypatch,
                                                     capsys):
    """``sources_in_one_column`` of ``port_bench/tests/faults/trio.py``:
    every read counted under source 0. The harness reports the run as not
    correct."""
    path = bench_run.HERE / "tests" / "faults" / "trio.py"
    spec = importlib.util.spec_from_file_location("trio_faults", path)
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    faults.sources_in_one_column(monkeypatch)
    last, jobs = run_tiny(bench_run, 0, monkeypatch, capsys)
    assert jobs and all(j["total_added"][1:] == [0, 0] for j in jobs)
    assert last["correct"] is False
    assert last["checks"]["table_rows_differing"]["value"] > 0
    assert last["checks"]["depth_positions_differing"]["value"] > 0


def test_the_cell_reports_its_metrics(bench_run):
    b = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in b["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "hapmers"
    e2e = [m["name"] for m in bench_run.cell_metrics(b, cell, False)]
    assert e2e == ["count_reads_per_s", "device_peak_gib", "setup_s"]
    layer = [m["name"] for m in bench_run.cell_metrics(b, cell, True)]
    assert set(layer) == set(SHARED + OWN) and len(layer) == len(SHARED + OWN)
    own = {m["name"]: m for m in b["per_layer"] if m["name"] in OWN}
    for m in own.values():
        assert m["workloads"] == [CELL] and m["moves"] == "count_reads_per_s"
    assert own["spectrum_n_share"]["source"] == "program_counter"
    assert own["depth_share"]["source"] == "program_counter"
    assert own["hapmer_idle_share"]["source"] == "device_trace"


def records(**timings):
    return {"jobs": [{"wall_s": 4.0, "timings": dict(timings)},
                     {"wall_s": 6.0, "timings": dict(timings)}]}


@pytest.mark.parametrize("name,key", [("spectrum_n_share", "spectrum_n_s"),
                                      ("depth_share", "depth_s")])
def test_share_of_the_jobs_seconds(bench_run, name, key):
    m = metric(bench_run, name)
    assert m.read(records(**{key: 0.25})) == pytest.approx(5.0)
    # a program without the counter (the parent of the spans) reads None
    assert m.read(records(spills=1)) is None
    assert m.read({"jobs": []}) is None


def hapmer_trace(with_spans: bool = True):
    """A 100 ns window: kmh.count [0, 40); kmh.store.spectrum_n [40, 60)
    holding kmh.store.fold [42, 44); kmh.count.depth [60, 90); a kernel
    [45, 50), a copy [65, 75) and a kernel [85, 95)."""
    from port_bench.trace import WINDOW, Trace

    ev = [(WINDOW, False, 0, 100), ("port_bench.job", False, 0, 100)]
    if with_spans:
        ev += [("kmh.count", False, 0, 40),
               ("kmh.store.spectrum_n", False, 40, 60),
               ("kmh.store.fold", False, 42, 44),
               ("kmh.count.depth", False, 60, 90)]
    ev += [("k1", True, 45, 50), ("Memcpy HtoD (Pageable -> Device)", True,
                                  65, 75), ("k2", True, 85, 95)]
    return Trace(events=ev)


def test_hapmer_idle_share_of_the_window(bench_run):
    m = metric(bench_run, "hapmer_idle_share")
    ctx = {"trace": hapmer_trace(),
           "trace_jobs": [{"wall_s": 100e-9}]}
    # spectrum_n innermost [40,42) [44,60): idle 2 + 11; depth [60,90):
    # idle 5 + 10; the fold's own [42,44) is not counted
    assert m.read(ctx) == pytest.approx(28.0)
    bare = {"trace": hapmer_trace(False),
            "trace_jobs": [{"wall_s": 1e-7}]}
    assert m.read(bare) is None
    assert m.read({"trace": None}) is None


def test_configuration_is_human_wgs151_k21_but_the_cut_and_the_trio():
    """Every key of ``human_wgs151_k21`` holds its value here but the
    genome's length and the read count, cut by 128 where the human cell
    cuts by 64; the trio's own keys are added; the store's two budgets are
    the human traffic's cut by 128."""
    from port_bench import run

    cfg_dir = run.HERE / "configs"
    human = json.loads((cfg_dir / "human_wgs151_k21.json").read_text())
    trio = json.loads((cfg_dir / "trio_wgs151_k21.json").read_text())
    text = {"name", "deployment", "source", "guarantees", "assumed",
            "reduced", "cuts", "tiny"}
    changed = {k for k in human if k not in text and human[k] != trio[k]}
    assert changed == {"genome_len", "batches"}
    assert set(trio) - set(human) == {"sources", "het_rate", "crossovers",
                                      "source_min"}
    assert trio["sources"] == 3 and trio["source_min"] == [2, 2, 2]
    assert trio["reduced"] == human["reduced"]
    assert trio["genome_len"] * 128 == 3_100_000_000
    reads = trio["batches"] * trio["batch_rows"]
    assert reads == 4_810_752
    assert 29.9 < reads * trio["read_len"] / trio["genome_len"] < 30.1
    _b, _c, _cfg, traffic = run.load_cell(CELL)
    _b, _c, _cfg, spill = run.load_cell("human_wgs151_k21.spill")
    assert traffic["kind"] == "trio" and traffic["warm_jobs"] == 2
    assert traffic["store"] == {k: v * 64 // 128
                                for k, v in spill["store"].items()}
    assert traffic["spectrum_n"] == {"comb": [1, 2, 3, 4, 5, 6, 7],
                                     "comb_inner": [1] * 7}
    assert set(trio["tiny"]) == {"genome_len", "batches", "batch_rows"}
