"""The span arithmetic of `bench/spans.py` on synthetic recorder spans over
the synthetic trace of `test_bench_metrics`, and one small run of the span
measurement on the CPU."""
from __future__ import annotations

import pytest
import torch

from bench import spans
from bench.tests import tiny
from bench.tests.test_bench_metrics import MS, synthetic
from repro_torch.obs.trace import Span


def recorded(shift_ms: float = 0.0) -> list:
    """Two steps of recorder spans over the synthetic trace's steps: the
    burst [1, 4] ms with two sub-steps of one RHS each, the turbulence
    [4, 9] ms holding a mass solve [6.5, 7.5] ms that synced twice."""
    out = []

    def add(name, a, b, parent, step, syncs=0):
        out.append(Span(name, int((a + shift_ms) * MS),
                        int((b + shift_ms) * MS), parent, step, syncs))
        return len(out) - 1

    for s in (0, 10):
        root = len(out)
        add("ocean.step", s + 0.5, s + 9.5, -1, root)
        burst = add("stage.external_burst", s + 1, s + 4, root, root)
        sub = add("burst.substep", s + 1.2, s + 2.6, burst, root)
        add("burst.rhs", s + 1.3, s + 1.8, sub, root)
        sub = add("burst.substep", s + 2.6, s + 3.8, burst, root)
        add("burst.rhs", s + 2.7, s + 3.6, sub, root)
        turb = add("stage.turbulence", s + 4, s + 9, root, root)
        add("vertical.mass_solve3d", s + 6.5, s + 7.5, turb, root, syncs=2)
    return out


def test_readers_of_the_span_window():
    ctx = {"spans": recorded(), "span_steps": 2}
    want = {"burst_host_ms_per_step": 3.0,
            "burst_host_us_per_substep": 1300.0,
            "dg_ops_host_ms_per_step": 5.0,
            "mass_solve_host_ms_per_step": 1.0,
            "host_syncs_per_step": 2.0}
    assert {m: spans.read(m, ctx) for m in spans.METRICS} == \
        pytest.approx(want)
    for absent in ({}, {"spans": [], "span_steps": 2},
                   {"spans": None, "span_steps": None}):
        assert all(spans.read(m, absent) is None for m in spans.METRICS)


def test_span_table_self_time():
    rows = spans.table(recorded(), 2)
    assert rows["ocean.step"] == pytest.approx(
        {"calls": 2, "host_ms": 9.0, "self_ms": 1.0, "syncs": 0})
    assert rows["burst.substep"] == pytest.approx(
        {"calls": 4, "host_ms": 2.6, "self_ms": 1.2, "syncs": 0})
    assert rows["vertical.mass_solve3d"]["syncs"] == 4
    assert list(rows)[0] == "ocean.step"


def test_substeps_in_order():
    assert spans.substeps_in_order(recorded()) == pytest.approx(
        {2: [1.4, 1.2]})


def test_gaps_and_launches_by_innermost_span():
    tr = synthetic()
    # gaps start at 3.5, 7, 8.75 ms of each step (13.5, 17 in the second;
    # the one after 18.75 is the window's end); launches at 1.5, 2, 4.5, 7
    bd = spans.by_span(tr, recorded())
    assert dict(bd["idle_gaps_by_span"]) == pytest.approx(
        {"burst.rhs": 0.003, "stage.turbulence": 0.00325,
         "vertical.mass_solve3d": 0.002})
    assert dict(bd["launches_by_span"]) == pytest.approx(
        {"burst.rhs": 1.0, "burst.substep": 1.0, "stage.turbulence": 1.0,
         "vertical.mass_solve3d": 1.0})
    assert spans.innermost(recorded(), [0, int(9.75 * MS)]) == \
        [spans.OUTSIDE, spans.OUTSIDE]


def test_last_steps_keeps_the_last_roots_and_their_spans():
    got = recorded()
    assert spans.last_steps(got, 1) == got[8:]
    assert spans.last_steps(got, 2) == got
    assert spans.last_steps(got[:8], 1) == got[:8]


def test_clock_check_pairs_ranges_with_spans():
    tr = synthetic()
    assert spans.clock_check(tr, recorded()) == {
        "pairs": 4, "median_us": 0.0, "min_us": 0.0, "max_us": 0.0}
    late = spans.clock_check(tr, recorded(shift_ms=0.02))
    assert late["pairs"] == 4
    assert late["median_us"] == pytest.approx(-20.0)


def test_a_small_span_run_on_the_cpu():
    """The measurement end to end at a small size: recording changes no
    bit, the spans hold the steps and their stages, every metric reads."""
    w = "front-f64.nl16-m20"
    out = spans.run(w, 2 ** 33 + 5, 2, torch.device("cpu"),
                    tiny.overrides(w))
    assert out["recording_changes_no_bit"]
    assert all(v is not None for v in out["metrics"].values())
    assert out["metrics"]["host_syncs_per_step"] == 0     # no card
    steps = 2 * spans.SPAN_STEPS
    rows = out["spans"]
    assert rows["ocean.step"]["calls"] == steps
    assert rows["burst.substep"]["calls"] == 30 * steps
    # the two windows' spans joined: each span's children still its own
    assert rows["ocean.step"]["self_ms"] < 0.01 * rows["ocean.step"]["host_ms"]
    assert rows["burst.substep"]["self_ms"] == pytest.approx(
        rows["burst.substep"]["host_ms"] - rows["burst.rhs"]["host_ms"])
    assert [w["recording"] for w in out["windows"]] == [False, True] * 2
    assert [len(v) for v in out["substeps_in_order_ms"].values()] == [10, 20]
    for cover in out["coverage"]:
        assert cover["steps_of_host"] > 0.9 and cover["stages_of_steps"] > 0.9
    # two imex ranges and 19 stage ranges a step, three steps
    assert out["traced"]["clock"]["pairs"] == 21 * 3
