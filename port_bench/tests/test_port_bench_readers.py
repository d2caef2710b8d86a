"""The metric readers: the byte counts of the two rooflines on hand-sized
batches, and the trace's busy time, idle gaps and kernel matching on a
trace made by hand."""
from __future__ import annotations

import pytest

from conftest import ROOT


def metric(name):
    from port_bench.run import load_module

    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py")


def test_scan_bytes_by_hand():
    scan = metric("scan_roofline")
    # 2 reads of 8 columns with the flag: each reads 8 bases, 8 qualities
    # and a 4-byte length, writes 8 emit bytes, 8 + 8 int64 registers a
    # column and its flag byte: 16 + 4 + 136 + 1 = 157 bytes a read
    assert scan.scan_bytes(2, 8) == 2 * 157
    # one of them again, exactly, without the flag: 156 more
    assert scan.scan_bytes(2, 8, flagged=1) == 2 * 157 + 156
    assert scan.scan_bytes(0, 152) == 0


def test_merge_bytes_by_hand():
    merge = metric("merge_roofline")
    # 10 keys read (80 bytes), 10 merged keys (80) and 10 row numbers (40)
    assert merge.merge_bytes(10) == 200


def events():
    """A 100 ns window, device work at 10-20, 15-30 (overlapping), 50-60;
    host ops: a copy over 30-50, a launch at 60-90."""
    return [("port_bench.window", False, 0, 100),
            ("port_bench.job", False, 0, 100),
            ("ll_scan_kernel<float, true>", True, 10, 20),
            ("merge_path_kernel", True, 15, 30),
            ("Memcpy DtoH (Device -> Pageable)", True, 50, 60),
            ("aten::copy_", False, 30, 50),
            ("cudaLaunchKernel", False, 60, 90),
            ("late kernel", True, 120, 130)]


def test_trace_busy_idle_and_gaps():
    from port_bench.trace import Trace

    tr = Trace(events=events())
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(30e-9)  # 10-30 and 50-60, once each
    assert tr.gaps() == [(0, 10), (30, 50), (60, 100)]
    assert tr.device_s([r"ll_scan_kernel"]) == pytest.approx(10e-9)
    assert tr.device_s([r"merge_path_kernel", r"\bpartition_kernel"]) == \
        pytest.approx(15e-9)
    b = tr.breakdown()
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(20e-9)
    assert gaps["cudaLaunchKernel"] == pytest.approx(40e-9)  # 60-100
    assert gaps["port_bench.job"] == pytest.approx(10e-9)  # 0-10: nothing else
    assert len(b["device_ops"]) == 3


def test_readers_on_a_hand_made_context():
    """Host-clock and counter readers read the untraced window's jobs,
    device-trace readers the traced window's."""
    from port_bench.trace import Trace

    ctx = {"trace": Trace(events=events()),
           "peaks": {"hbm_bytes_per_s": 1e9}, "window_s": 2.0,
           "setup_s": 3.5, "peak_bytes": 3 * 2 ** 30,
           "traffic": {"kind": "count"},
           "jobs": [{"reads": 4, "wall_s": 1.0, "width": 8,
                     "flagged_reads": 0, "b3_rows": 5,
                     "timings": {"tier_merge_s": 0.25}}],
           "trace_jobs": [{"reads": 4, "wall_s": 2.0, "width": 8,
                           "flagged_reads": 1, "b3_rows": 10,
                           "timings": {"tier_merge_s": 1.5}}]}
    assert metric("count_reads_per_s").read(ctx) == 2.0
    assert metric("setup_s").read(ctx) == 3.5
    assert metric("device_peak_gib").read(ctx) == 3.0
    assert metric("tier_merge_share").read(ctx) == 25.0
    idle = metric("idle_share.count").read(ctx)
    assert idle == pytest.approx(70.0)
    scan = metric("scan_roofline")
    need = scan.scan_bytes(4, 8, 1)
    assert scan.read(ctx) == pytest.approx(100 * need / 10e-9 / 1e9)
    merge = metric("merge_roofline")
    assert merge.read(ctx) == pytest.approx(100 * 200 / 15e-9 / 1e9)
    assert metric("index_bases_per_s").read(ctx) is None


def test_index_and_query_readers_by_window():
    from port_bench.trace import Trace

    ctx = {"trace": Trace(events=events()), "window_s": 4.0,
           "traffic": {"kind": "index"},
           "jobs": [{"bases": 10, "wall_s": 2.0, "tables_s": 0.5},
                    {"bases": 10, "wall_s": 2.0, "tables_s": 1.5}],
           "trace_jobs": [{"bases": 10, "wall_s": 50e-9, "tables_s": 0.0}]}
    assert metric("index_bases_per_s").read(ctx) == 5.0
    assert metric("table_copy_share").read(ctx) == 50.0
    # no device activity matches a sort: nought of the traced jobs' time
    assert metric("sort_share").read(ctx) == 0.0
    lat = [0.001 * (i + 1) for i in range(20)]
    ctx = {"traffic": {"kind": "query"}, "window_s": 1.0,
           "jobs": [{"bases": 3, "wall_s": t, "latency_s": t} for t in lat],
           "trace_jobs": [{"bases": 3, "wall_s": 9.0, "latency_s": 9.0}]}
    assert metric("query_bases_per_s").read(ctx) == 60.0
    assert metric("query_p50_ms").read(ctx) == pytest.approx(10.5)
    assert metric("query_p95_ms").read(ctx) == pytest.approx(19.05)


def test_readers_find_nothing_without_a_trace_or_a_card():
    ctx = {"trace": None, "peaks": {}, "window_s": 1.0, "jobs": [],
           "trace_jobs": None, "peak_bytes": None,
           "traffic": {"kind": "query"}}
    for name in ("scan_roofline", "merge_roofline", "sort_share",
                 "idle_share.query", "device_peak_gib", "query_p95_ms",
                 "query_bases_per_s"):
        assert metric(name).read(ctx) is None, name
