"""The copied kernel formulas against the port's kernel table (PERF.md, at
the main path's float32 shapes, 160,000 x 16) and the calls a step makes
against the program's own calls, seen through its tap on the CPU."""
from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch

from bench import roofline, sides
from bench.tests import tiny

NT, NL, F32 = 160_000, 16, 4


@pytest.mark.parametrize("cost, bytes_", [
    (lambda: roofline.block_thomas(2, NL, NT, F32), 1_305_600_000),
    (lambda: roofline.lateral_flux(4, NL, NT, F32), 1_107_840_000),
    (lambda: roofline.solve_r(2, NL, NT, F32), 250_240_000),
    (lambda: roofline.solve_w(1, NL, NT, F32), 123_520_000),
    (lambda: roofline.tridiag(NL, NT, F32), 51_200_000),
])
def test_bytes_equal_the_kernel_table(cost, bytes_):
    assert cost()[0] == bytes_


@pytest.mark.parametrize("name, args", [
    ("solve_r", ((2, NL, 6, NT), (NT,), (2, 3, NT))),
    ("solve_w", ((1, NL, 6, NT), (NT,), None)),
    ("block_thomas", ((NL, 6, 6, NT),) * 3 + ((2, NL, 6, NT),)),
    ("lateral_flux", ((4, NL, 6, NT), (4, NL, 3, 2, 2, NT),
                      (NL, 2, 3, 2, NT), (3, NT))),
    ("tridiag", ((NL, NT),) * 4),
])
def test_formulas_equal_the_ports(name, args):
    """The copy gives what the port's `roofline/kernels.py` gives."""
    sides.port_modules()
    from repro_torch.roofline import kernels as port
    ts = [None if a is None else torch.empty(a, dtype=torch.float64,
                                             device="meta") for a in args]
    want = port.COST[name](*ts)
    lead = {"solve_r": 2, "solve_w": 1, "block_thomas": 2,
            "lateral_flux": 4, "tridiag": None}[name]
    fn = getattr(roofline, name)
    got = fn(NL, NT, 8) if lead is None else fn(lead, NL, NT, 8)
    assert got == (want.bytes, want.flops)


@pytest.mark.parametrize("workload", ["front-f64.nl16-m20",
                                      "gbr-f64.nl20-m20"])
def test_step_calls_are_the_programs(workload):
    """One step of the program on the plain backend calls each kernel as
    often, and with the leading sizes, that STEP_CALLS costs."""
    sides.port_modules()
    from repro_torch.kernels import ops
    from bench import inputs, spec
    seen = []

    def tap(kernel, operands):
        # the leading size: components, right-hand sides, or K7's layers
        lead = operands[3 if kernel == "block_thomas" else 0].shape[0]
        seen.append((kernel, lead))
        return contextlib.nullcontext()
    wl = spec.workload(workload)
    case = dict(spec.config(wl["config"]), mesh=tiny.mesh(workload))
    traffic = dict(spec.traffic(wl["traffic"]), nl=3)
    inp = inputs.make_inputs(case, traffic, 5, tiny.CPU)
    prog = sides.build(sides.port_modules(), inp, torch.float64, tiny.CPU)
    prog.cfg = dataclasses.replace(prog.cfg, backend="plain")
    with ops.tapped(tap):
        prog.advance(prog.state)
    want = sorted((k, 3 if lead is None else lead)
                  for k, calls in roofline.STEP_CALLS.items()
                  for _, lead in calls)
    assert sorted(seen) == want
