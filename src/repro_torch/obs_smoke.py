"""Observability smoke: a 3-step fully-instrumented simulation.

Runs the f64 standing-wave case (rect_mesh(6, 5) of 2000 m x 1500 m, 20 m
deep, 4 layers, 6 external sub-steps, dt 5 s) with the flight recorder on:
a JSONL metrics sink in a run directory, host stage timers, the physics
diagnostics checked by a halt-mode MonitorPolicy, and a final registry
flush (kernel dispatch counters, timer histograms).  Then validates the
JSONL against the schema and checks that the stream covers the three
record families the flight recorder promises:

  * stage timings        (histogram "stage_time_us")
  * physics diagnostics  (diagnostics "physics", one per step)
  * kernel dispatch      (counter "kernel_dispatch")

Exit codes: 0 ok, 1 schema/coverage failure, 2 monitor violation.

    PYTHONPATH=src python -m repro_torch.obs_smoke [--steps N] [--run-dir D]
        [--trace] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import torch

from .core import dg2d, geometry, mesh2d, stepper
from .core.extrusion import VGrid
from .kernels.dispatch import default_device
from .obs import diagnostics as obs_diag
from .obs import metrics, schema, trace


def setup(device):
    """The standing-wave case of the JAX package's obs smoke, in float64."""
    m = mesh2d.rect_mesh(6, 5, 2000.0, 1500.0, jitter=0.2, seed=3)
    geom = geometry.geom2d_from_mesh(m, dtype=torch.float64, device=device)
    cfg = stepper.OceanConfig(dt=5.0, nl=4, m_2d=6)
    vg = VGrid(b=torch.full((3, m.nt), 20.0, dtype=torch.float64,
                            device=device), nl=cfg.nl)
    st = stepper.init_state(geom, vg, dtype=torch.float64)
    eta = 0.05 * torch.cos(math.pi * geom.node_x / 2000.0)
    st = dataclasses.replace(st, ext=dg2d.State2D(eta, st.ext.qx, st.ext.qy))
    return geom, vg, cfg, st


REQUIRED = {
    "stage timings": lambda r: r["kind"] == "histogram"
    and r["name"] == "stage_time_us",
    "physics diagnostics": lambda r: r["kind"] == "diagnostics"
    and r["name"] == "physics",
    "kernel dispatch": lambda r: r["kind"] == "counter"
    and r["name"] == "kernel_dispatch",
}


def check_jsonl(path: str, steps: int) -> list:
    """Schema errors and coverage gaps of a metrics JSONL, as messages."""
    _, errors = schema.validate_file(path)
    if errors:
        return [f"schema line {lineno}: {err}" for lineno, err in errors]
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    missing = [k for k, pred in REQUIRED.items()
               if not any(pred(r) for r in recs)]
    n_diag = sum(1 for r in recs if r["kind"] == "diagnostics")
    if missing or n_diag < steps:
        return [f"coverage: missing={missing} diagnostics={n_diag}/{steps}"]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="also capture a torch.profiler trace")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    run_dir = args.run_dir or trace.default_run_dir(prefix="obs")
    os.makedirs(run_dir, exist_ok=True)
    jsonl = os.path.join(run_dir, "metrics.jsonl")
    metrics.reset()
    reg = metrics.configure(jsonl)

    geom, vg, cfg, st = setup(device)
    policy = obs_diag.MonitorPolicy(
        cfl_max=1.0, eta_max=1.0, speed_max=5.0,
        tracer_bounds={"T": (9.0, 11.0), "S": (34.0, 36.0)},
        volume_drift_max=1e-10, mass_drift_max=1e-10,
        on_violation="halt")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    try:
        with trace.trace_session(run_dir=run_dir, enabled=args.trace):
            for k in range(args.steps):
                with reg.timer("stage_time_us", stage="step"):
                    st, diag = obs_diag.step_with_diagnostics(geom, vg, cfg, st)
                    sync()
                policy.check(diag, step=k, registry=reg)
    except obs_diag.MonitorHalt as e:
        print(f"FAIL monitor violation: {e}", file=sys.stderr)
        return 2
    finally:
        reg.flush(step=args.steps)
        metrics.configure(None)             # closes and detaches the sink

    problems = check_jsonl(jsonl, args.steps)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if problems:
        return 1
    print(f"OK {jsonl} is schema-valid with stage timings, {args.steps} "
          f"physics diagnostics and kernel dispatch counters on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
