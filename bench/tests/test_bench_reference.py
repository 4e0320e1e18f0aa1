"""The frozen reference against the port's step on the CPU, and the
import rules: the reference imports nothing of the port, and a run loads
no module named jax, jaxlib, flax or repro (whole top-level names)."""
from __future__ import annotations

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import compare, inputs, sides, spec
from bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("workload", ["front-f64.nl16-m20",
                                      "gbr-f64.nl20-m40"])
@pytest.mark.parametrize("backend, fused, tol", [
    ("ref", False, 0.0),       # the copy's own path: the same ops, bitwise
    ("plain", True, 1e-10),    # the kernels' plain versions, fused path
])
def test_reference_equals_the_ports_step(workload, backend, fused, tol):
    wl = spec.workload(workload)
    case = dict(spec.config(wl["config"]), mesh=tiny.mesh(workload))
    traffic = dict(spec.traffic(wl["traffic"]), nl=3)
    inp = inputs.make_inputs(case, traffic, 17, tiny.CPU)
    prog = sides.build(sides.port_modules(), inp, torch.float64, tiny.CPU)
    ref = sides.build(sides.reference_modules(), inp, torch.float64,
                      tiny.CPU)
    port_cfg = dataclasses.replace(prog.cfg, backend=backend,
                                   fused_horizontal=fused)
    st, rst = prog.state, ref.state
    for _ in range(3):
        st = sides.port_modules().stepper.step(
            prog.geom, prog.vg, port_cfg, st, prog.forcing_at(st.time))
        rst = ref.advance(rst)
    gap = compare.gaps(compare.fields(st), compare.fields(rst))
    assert max(gap.values()) <= tol, gap


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "bench"), (path.name, n)


def test_a_run_loads_no_forbidden_module():
    """A whole small run in a fresh interpreter (the repository's test
    configuration loads JAX into this one)."""
    code = (
        "import sys, time, torch\n"
        "from bench.tests import tiny\n"
        "from bench import harness\n"
        "out = tiny.run('gbr-f64.nl20-m20', traced=True)\n"
        "assert out['correct'], out['checks']\n"
        "found = harness.forbidden_modules()\n"
        "assert 'repro_torch' in sys.modules\n"
        "print('FOUND', found)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlib2", sys)
    assert not {"repro_torch_like", "jaxlib2"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()
