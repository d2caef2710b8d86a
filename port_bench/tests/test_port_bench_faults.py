"""With the timed path broken underneath, a run says ``correct: false``:
for every cell, each fault of its job kind (``faults/<kind>.py``): a step
that leaves its state unchanged, half of the work left out, and an answer
altered where it is produced (one card, so no exchange between cards to
leave out). And the controls that the limits were set from, at a tiny
size: the guarantee control fails every cell; the program's own float32
filter reads nought on the binned qualities of the counting configuration
(PERF.md says why)."""
from __future__ import annotations

import pytest

from conftest import CELLS, faults, kind, tiny

CASES = [(w, f) for w in CELLS for f in faults(kind(w))]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_a_broken_path_is_not_correct(tiny_run, monkeypatch, workload,
                                      fault):
    fault(monkeypatch)
    rc, last, _out, err = tiny_run(workload)
    assert rc == 0, err
    assert last["correct"] is False
    assert any(c["value"] > c["limit"] for c in last["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_controls(workload):
    from port_bench import control

    got = {r["control"]: r["checks"]
           for r in control.readings(workload, 2_147_483_713, "cpu",
                                     tiny(workload))}
    assert all(v == 0 for v in got["program"].values())
    assert any(v > 0 for v in got["guarantee"].values())
    if kind(workload) == "count":
        assert all(v == 0 for v in got["f32"].values())
