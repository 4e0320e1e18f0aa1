"""The comparison that decides `correct`, at a size a test run holds: the
program's small runs pass it; the control (the reference in float32, the
precision below the configuration's) and runs with the timed path broken
underneath fail it.  The limits are the cells' own."""
from __future__ import annotations

import dataclasses
import sys
import types

import pytest
import torch

from bench import compare, flops, harness, inputs, run, sides, spec
from bench.tests import tiny

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def no_import_check(monkeypatch):
    """The repository's test configuration loads JAX into this process;
    the check itself is held in a fresh one
    (test_bench_reference.test_a_run_loads_no_forbidden_module)."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_small_runs_are_correct(workload, no_import_check):
    out = tiny.run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_float32_control_fails(workload):
    wl = spec.workload(workload)
    case = dict(spec.config(wl["config"]), mesh=tiny.mesh(workload))
    traffic = dict(spec.traffic(wl["traffic"]), nl=3)
    inp = inputs.make_inputs(case, traffic, 23, tiny.CPU)
    ref = sides.reference_modules()
    got = {}
    for dtype in (torch.float64, torch.float32):
        side = sides.build(ref, inp, dtype, tiny.CPU)
        st = side.state
        for _ in range(4):
            st = side.advance(st)
        got[dtype] = compare.fields(st)
    gap = compare.gaps(got[torch.float32], got[torch.float64])
    correct, checks = compare.judge(gap, spec.cell(workload)["limits"])
    assert not correct, checks


def _broken(fault: str) -> types.SimpleNamespace:
    port = sides.port_modules()
    real = port.stepper.step

    def step(geom, vg, cfg, st, forcing):
        # the step's work is done in every fault, so the window holds as
        # many steps as a sound run's and the reference follows as many
        new = real(geom, vg, cfg, st, forcing)
        if fault == "unchanged":
            return st
        if fault == "half_left_out":
            half = geom.nt // 2
            for name in ("ux", "uy", "T", "S", "turb_k", "turb_eps",
                         "nu_t", "kappa_t"):
                getattr(new, name)[..., half:] = getattr(st, name)[..., half:]
            return new
        # fault == "altered": one value of the step's answer, where it is
        # produced
        T = new.T.clone()
        T[0, 0, 0] *= 1 + 1e-4
        return dataclasses.replace(new, T=T)
    stepper = types.SimpleNamespace(**vars(port.stepper))
    stepper.step = step
    return types.SimpleNamespace(**{**vars(port), "stepper": stepper})


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
@pytest.mark.parametrize("workload", ["front-f64.nl16-m20",
                                      "gbr-f64.nl20-m20"])
def test_a_broken_timed_path_is_not_correct(workload, fault,
                                            no_import_check):
    out = tiny.run(workload, port=_broken(fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_flops_recount_at_a_small_size(workload):
    """The stored count is a nt + c: a recount on a mesh that neither fit
    used gives a nt + c there."""
    cell = spec.cell(workload)
    got, nt = flops.count_step(workload, 16)
    assert got == cell["per_triangle"] * nt + cell["constant"]
    m = spec.config(spec.workload(workload)["config"])["mesh"]
    assert cell["flops_per_step"] == (cell["per_triangle"] * 2 * m["nx"]
                                      * m["ny"] + cell["constant"])


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "2147483649",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


def test_refuses_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_refuses_a_checkout_without_the_program(monkeypatch, tmp_path):
    monkeypatch.setattr(sides, "ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="no repro_torch"):
        sides.port_modules()
