"""The benchmark's human 30x counting cell, ``human_wgs151_k21.spill``, at
its tiny size on the CPU through ``port_bench``: correct, and every job
spills and folds by key range, and a planted fault in the ranged fold is
reported as not correct. Then its per-layer metrics on records and traces
whose every number is known, and its configuration against
``wgs151_k21``'s."""
import json

import pytest

from port_bench import run as bench_run
from port_bench.trace import WINDOW, Trace

CELL = "human_wgs151_k21.spill"
# the count path's metrics, read on this cell too, then its own
SHARED = ("tier_merge_share", "scan_roofline", "merge_roofline",
          "idle_share.count", "stage_idle_share", "batch_idle_share",
          "tier_merge_device_share", "idle_outside_program.count")
OWN = ("spill_share", "rejoin_share", "staging_link_share",
       "spill_idle_share")
DEVICE = {"scan_roofline", "merge_roofline", "idle_share.count",
          "stage_idle_share", "batch_idle_share", "tier_merge_device_share",
          "idle_outside_program.count", "staging_link_share",
          "spill_idle_share"}


def tiny(cell: str = CELL) -> dict:
    _b, _cell, cfg, traffic = bench_run.load_cell(cell)
    return {"config": cfg["tiny"], "traffic": traffic["tiny"]}


def metric(name: str):
    return bench_run.load_module(bench_run.HERE / "metrics" / f"{name}.py")


def run_tiny(trace: int, monkeypatch, capsys, cell: str = CELL):
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
    rc = bench_run.main(["--workload", cell, "--seed", "4294967311",
                         "--seconds", "0.3", "--trace", str(trace),
                         "--device", "cpu"], overrides=tiny(cell))
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), jobs


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct_and_every_job_spills_and_folds_by_range(
        trace, monkeypatch, capsys):
    last, jobs = run_tiny(trace, monkeypatch, capsys)
    assert last["correct"] is True and last["failed"] == 0
    assert last["checks"]["table_rows_differing"]["value"] == 0
    assert last["checks"]["spectrum_bins_differing"]["value"] == 0
    assert jobs
    for j in jobs:
        tm = j["timings"]
        assert tm["spills"] >= 2
        assert tm["ranged_folds"] == 1 and tm["ranges"] >= 2
        assert tm["rejoined_rows"] == tm["spilled_rows"] > 0
    got = last["metrics"]
    if trace:
        assert got["spill_share"]["value"] > 0
        assert got["rejoin_share"]["value"] > 0
        assert "tier_merge_share" in got
        # the CPU stages nothing and has no device activity
        assert not DEVICE & set(got)
    else:
        assert {"count_reads_per_s", "setup_s"} <= set(got)


def test_a_range_boundary_dropped_in_the_fold_is_not_correct(
        monkeypatch, capsys):
    """A planted fault in the ranged fold: every key-range slice that does
    not start its run loses its first row (the row at the range's lower
    boundary). The harness's own comparison reports the table as not
    correct."""
    from kmer_hasher_tpu_torch.index.count_store import CountStore

    range_slice = CountStore._range_slice

    def drop_boundary(self, keys, cnt):
        if keys.storage_offset() > 0:  # a slice past its run's start
            keys, cnt = keys[1:], cnt[1:]
        return range_slice(self, keys, cnt)

    monkeypatch.setattr(CountStore, "_range_slice", drop_boundary)
    last, jobs = run_tiny(0, monkeypatch, capsys)
    assert jobs and all(j["timings"]["ranged_folds"] == 1 for j in jobs)
    assert last["correct"] is False
    assert last["checks"]["table_rows_differing"]["value"] > 0


def test_a_store_without_spill_bytes_never_enters_the_range_pass(
        monkeypatch, capsys):
    """The staged cell at its tiny size: its store has no ``spill_bytes``,
    so its flush takes the resident fold and never the ranged one."""
    from kmer_hasher_tpu_torch.index.count_store import CountStore

    def refuse(*_a, **_k):
        raise AssertionError("the ranged fold ran without a spill")

    for name in ("_fold_spilled_ranged", "_merge_range", "_range_slice"):
        monkeypatch.setattr(CountStore, name, refuse)
    last, jobs = run_tiny(0, monkeypatch, capsys, cell="wgs151_k21.staged")
    assert last["correct"] is True and jobs
    for j in jobs:
        tm = j["timings"]
        assert tm["folds"] >= 1 and tm["spills"] == tm["ranged_folds"] == 0
        assert tm["range_rounds"] == 0


def test_the_cell_reports_its_metrics():
    b = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in b["workloads"]}[CELL]
    e2e = [m["name"] for m in bench_run.cell_metrics(b, cell, False)]
    assert e2e == ["count_reads_per_s", "device_peak_gib", "setup_s"]
    layer = [m["name"] for m in bench_run.cell_metrics(b, cell, True)]
    assert layer == list(SHARED + OWN)
    staged = {w["name"]: w for w in b["workloads"]}["wgs151_k21.staged"]
    on_staged = [m["name"] for m in bench_run.cell_metrics(b, staged, True)]
    assert set(SHARED) <= set(on_staged)


def records(**timings):
    return {"jobs": [{"wall_s": 4.0, "timings": dict(timings)},
                     {"wall_s": 6.0, "timings": dict(timings)}]}


@pytest.mark.parametrize("name,key", [("spill_share", "spill_s"),
                                      ("rejoin_share", "rejoin_s")])
def test_share_of_the_jobs_seconds(name, key):
    assert metric(name).read(records(**{key: 0.5})) == pytest.approx(10.0)
    # a program without the counter (the parent of the rejoin's) reads None
    assert metric(name).read(records(spills=1)) is None
    assert metric(name).read({"jobs": []}) is None


def test_staging_link_share_is_bytes_over_seconds_over_the_link():
    """The staged bytes over the device seconds of the pinned copies that
    overlap their spans, each direction in its own span only."""
    m = metric("staging_link_share")
    assert m.LINK_BYTES_PER_S == 64e9
    down, up = "Memcpy DtoH (Device -> Pinned)", "Memcpy HtoD (Pinned -> Device)"
    ev = [(WINDOW, False, 0, 1000), ("kmh.store.spill", False, 100, 200),
          ("kmh.store.spill", False, 150, 180),
          ("kmh.store.rejoin", False, 500, 800),
          (down, True, 110, 130), (down, True, 190, 230),  # 20 + 40
          (up, True, 600, 640),  # 40
          (up, True, 120, 140),  # a batch's upload: not in a rejoin
          (down, True, 600, 700),  # a readback's way: not a spill's
          (down, True, 300, 400), (up, True, 850, 900)]  # outside the spans
    ctx = {"trace": Trace(events=ev),
           "trace_jobs": [{"wall_s": 1.0, "timings": {"staging_bytes": 32}},
                          {"wall_s": 1.0, "timings": {"staging_bytes": 32}}]}
    assert m.copy_s(ctx["trace"]) == pytest.approx(100e-9)
    # 64 bytes in 100 ns: 0.64 GB/s of 64 GB/s
    assert m.read(ctx) == pytest.approx(1.0)
    # a program without the counter, a trace without the copies
    assert m.read({**ctx, "trace_jobs": [{"wall_s": 1.0, "timings": {}}]}
                  ) is None
    bare = Trace(events=ev[:4])
    assert m.read({**ctx, "trace": bare}) is None
    assert m.read({**ctx, "trace": None}) is None


def spill_trace(with_spans: bool = True) -> Trace:
    """A 100 ns window: kmh.count [0, 60) holding kmh.store.spill [10, 30),
    then kmh.store.fold [60, 100) holding kmh.store.rejoin [65, 95);
    a kernel [20, 25), a copy [40, 50) and a kernel [70, 80)."""
    ev = [(WINDOW, False, 0, 100), ("port_bench.job", False, 0, 100)]
    if with_spans:
        ev += [("kmh.count", False, 0, 60), ("kmh.store.spill", False, 10, 30),
               ("kmh.store.fold", False, 60, 100),
               ("kmh.store.rejoin", False, 65, 95)]
    ev += [("k1", True, 20, 25), ("Memcpy DtoH (Device -> Pinned)", True, 40,
                                  50), ("k2", True, 70, 80)]
    return Trace(events=ev)


def test_device_metrics_of_the_spill_and_rejoin_spans():
    ctx = {"trace": spill_trace(), "trace_jobs": [{"wall_s": 100e-9}]}
    # idle: [0,20) [25,40) [50,70) [80,100): 75 of 100
    assert metric("idle_share.count").read(ctx) == pytest.approx(75.0)
    # spill [10,30) idle 15, rejoin [65,95) idle 5 + 15
    assert metric("spill_idle_share").read(ctx) == pytest.approx(35.0)
    bare = {"trace": spill_trace(False), "trace_jobs": [{"wall_s": 1e-7}]}
    assert metric("spill_idle_share").read(bare) is None


def test_configuration_is_wgs151_k21_but_the_cut():
    """Every key of ``wgs151_k21`` holds its value here but the genome's
    length and the read count, which ``reduced`` names with the store's
    two budgets, cut by 64 from the uncut deployment."""
    cfg_dir = bench_run.HERE / "configs"
    small = json.loads((cfg_dir / "wgs151_k21.json").read_text())
    human = json.loads((cfg_dir / "human_wgs151_k21.json").read_text())
    text = {"name", "deployment", "source", "guarantees", "assumed",
            "reduced", "tiny"}
    changed = {k for k in small if k not in text and small[k] != human[k]}
    assert changed == {"genome_len", "batches"}
    assert human["reduced"] == ["genome_len", "batches", "spill_bytes",
                                "fold_budget_bytes"]
    assert human["genome_len"] * 64 == 3_100_000_000
    reads = human["batches"] * human["batch_rows"]
    assert reads == 9_621_504
    assert 29.9 < reads * human["read_len"] / human["genome_len"] < 30.1
    _b, _c, _cfg, traffic = bench_run.load_cell(CELL)
    assert traffic["store"] == {"spill_bytes": (16 << 30) // 64,
                                "fold_budget_bytes": (40 << 30) // 64}
    assert set(human["guarantees"][:3]) == set(small["guarantees"])
