"""One run of one cell: set-up, the measured window, the traced steps, the
comparison with the plain reference, and the result line.

The window drives `repro_torch.core.stepper.step` in a closed loop: one
simulation, steps back to back, each step taking the state the one before
returned, with no host synchronisation added between them.  CUDA events
recorded on the stream at every step boundary time each step; the host
clock times the whole window, from the first step's launch to the
`synchronize()` after the last.
"""
from __future__ import annotations

import gc
import statistics
import subprocess
import sys
import time
from typing import Optional

import torch

from . import compare, inputs, sides, spec
from . import trace as trace_mod

WARM_STEPS = 2        # set-up: the first builds and loads the kernels
TRACED_STEPS = 3      # the traced sub-window, after one warm traced step
GIB = 2.0 ** 30
# module names that may not be loaded in a run (compared whole, by the
# part before the first dot: `repro_torch` is not `repro`)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RANGES = ("imex.stage1", "imex.stage2", "stage.edge_cache",
          "stage.pressure_gradient", "stage.flux_prediction",
          "stage.external_burst", "stage.turbulence", "stage.w_solve",
          "stage.horizontal_rhs", "stage.momentum_update",
          "stage.tracer_update", "stage.turbulence_final",
          "halo.exchange")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class StepClock:
    """Step boundaries: CUDA events on the stream on a card, the host clock
    elsewhere (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p90(values: list) -> float:
    """The 90th percentile, linear between order statistics."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _launches():
    from repro_torch.kernels.dispatch import LAUNCHES
    return dict(LAUNCHES)


def _traced(prog, st, device):
    """One warm traced step (the profiler's own start-up), then
    TRACED_STEPS traced ones.  Returns (state, Trace, launch counts of
    the traced steps)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        st = prog.advance(st)
        sync(device)
    before = _launches()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            st = prog.advance(st)
        sync(device)
        window_s = time.perf_counter() - t0
    after = _launches()
    counts = {k[0]: after[k] - before.get(k, 0) for k in after
              if k[1] == "cuda" and after[k] != before.get(k, 0)}
    tr = trace_mod.from_events(prof.profiler.kineto_results.events(),
                               TRACED_STEPS, window_s, RANGES)
    return st, tr, counts


def _breakdown(tr) -> dict:
    by_name = {}
    for op in tr.ops:
        by_name[op.name] = by_name.get(op.name, 0) + op.dur_ns
    by_range = {}
    for t, length in tr.gaps():
        name = tr.range_open_at(t)
        by_range[name] = by_range.get(name, 0) + length
    top = lambda d: [[n[:160], v / 1e9] for n, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_name), "idle_gaps": top(by_range)}


def load(workload: str, overrides: dict = None) -> tuple:
    """(configuration, traffic, cell, dtype) of ``workload``, with
    ``overrides`` patched into the configuration and the traffic."""
    wl = spec.workload(workload)
    case = dict(spec.config(wl["config"]))
    traffic = dict(spec.traffic(wl["traffic"]))
    for key, value in (overrides or {}).items():
        (traffic if key in traffic else case)[key] = value
    return case, traffic, spec.cell(workload), getattr(torch, case["dtype"])


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, overrides: dict = None,
             port=None) -> dict:
    """Run ``workload`` once and return the result line's object.

    ``overrides`` patches the configuration and the traffic (the CPU tests
    run a small mesh); ``port`` replaces the program's modules (the tests
    break the timed path underneath)."""
    case, traffic, cell, dtype = load(workload, overrides)
    port = port or sides.port_modules()

    # --- set-up ----------------------------------------------------------
    marks = [("imports", time.perf_counter())]
    inp = inputs.make_inputs(case, traffic, seed, device)
    marks.append(("inputs", time.perf_counter()))
    prog = sides.build(port, inp, dtype, device)
    marks.append(("program", time.perf_counter()))
    st = prog.state
    for _ in range(WARM_STEPS):
        st = prog.advance(st)
    sync(device)
    marks.append(("warm_steps", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    # --- the measured window ---------------------------------------------
    clock = StepClock(device)
    t0 = time.perf_counter()
    clock.mark()
    n = 0
    while True:
        st = prog.advance(st)
        clock.mark()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    wall_s = time.perf_counter() - t0
    step_ms = clock.step_ms()
    steps = WARM_STEPS + n
    tr = counts = None
    if traced:
        st, tr, counts = _traced(prog, st, device)
        steps += 1 + TRACED_STEPS
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")

    prog_fields = compare.fields(st)
    del prog, st
    ctx = {"dtype": case["dtype"], "nl": inp.nl, "nt": inp.mesh.nt,
           "m_2d": inp.m_2d, "dt": case["dt"], "cell": cell, "steps": n,
           "wall_s": wall_s, "step_ms": step_ms, "trace": tr,
           "launches": counts}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak,
           "power_limit_w": (power_limit_w() if device.type == "cuda"
                             else None)}
    if traced:
        dev["busy_s"] = tr.busy_ns() / 1e9
        dev["window_s"] = tr.window_s
    return conclude(workload, inp, dtype, device, prog_fields, steps, ctx,
                    setup_s, marks, t_start, dev)


def conclude(workload: str, inp, dtype: torch.dtype, device: torch.device,
             prog_fields: dict, steps: int, ctx: dict, setup_s: float,
             marks: list, t_start: float, dev: dict) -> dict:
    """The plain reference over the ``steps`` the program made, the
    comparison of ``prog_fields`` (the program's final state, its own
    freed) with it, the cell's metrics from ``ctx``, and the result line's
    object."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = sides.build(sides.reference_modules(), inp, dtype, device)
    rst = ref.state
    for _ in range(steps):
        rst = ref.advance(rst)
    limits = ctx["cell"]["limits"]
    gap = compare.gaps(prog_fields, compare.fields(rst), limits)
    correct, checks = compare.judge(gap, limits)
    print(f"reference: {steps} steps in {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)

    finite = all(bool(torch.isfinite(v).all()) for v in prog_fields.values())
    n, wall_s, step_ms = ctx["steps"], ctx["wall_s"], ctx["step_ms"]
    kind = "per_layer" if ctx["trace"] is not None else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(workload, kind):
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"] == "sim_s_per_s":
            value = n * ctx["dt"] / wall_s
        elif m["name"] == "step_ms_p90":
            value = p90(step_ms)
        elif m["name"] == "peak_mem_gib":
            value = dev["memory_peak_bytes"] / GIB
        else:
            value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    setup_parts = {name: t - prev for (name, t), prev in
                   zip(marks, [t_start] + [t for _, t in marks[:-1]])}
    out = {"correct": correct, "attempted": n, "failed": 0 if finite else n,
           "metrics": metrics, "device": dev,
           "steps": {"window": n, "compared": steps, "wall_s": wall_s,
                     "step_ms": step_ms},
           "setup_parts_s": setup_parts}
    if ctx["trace"] is not None:
        out["breakdown"] = _breakdown(ctx["trace"])
    out["checks"] = checks
    return out
