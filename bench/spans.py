"""The program's own spans over a cell's steps (`repro_torch.obs.trace`):
host time a layer in steps that run without the profiler, the host's syncs
by span, and the profiled steps' idle gaps and launches put down to the
innermost span open on the host.

    python3 -m bench.spans --workload <cell> --seed <n> [--rounds 4]
        [--json-out FILE]

After the cell's set-up (as `bench.run` makes it), one step from one state
with and without recording, whose states must be bitwise equal; then
``--rounds`` pairs of windows of SPAN_STEPS steps, one plain and one
recording (the span windows), each ending in a synchronize(), so that
recording's cost is read against the same process's steps; then, with
recording on, the harness's traced window (`harness._traced`: the
profiler's warm step and TRACED_STEPS profiled steps, as in a ``--trace 1``
run), of whose spans the last TRACED_STEPS steps' are kept.  Prints one
JSON object: the span table over the span windows, the per-layer values of
`read` over them, the wall a step of each window, how much of the host's
time the spans cover, the profiled steps' idle gaps and launches by span,
and the distance between each profiler range and the recorder's span of
the same name (the clock check).

`read(name, ctx)` is the arithmetic of the per-layer metrics that read the
spans: ``ctx["spans"]`` (`trace.drain()` of the span window) and
``ctx["span_steps"]``; it returns None where they are absent, as on a
program without the recorder.  Syncs count where a recorded span was open:
a synchronize() that closes a window is not the step's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from . import harness, inputs, sides, spec

SPAN_STEPS = 3
BURST = "stage.external_burst"
MASS_SOLVE = "vertical.mass_solve3d"
SUBSTEP = "burst.substep"
OUTSIDE = "outside the spans"


def _per_step_ms(spans, name, steps):
    ns = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return sum(ns) / 1e6 / steps if ns else None


def read(name: str, ctx: dict):
    """The per-layer metric ``name`` of the span window in ``ctx``, or None."""
    spans, steps = ctx.get("spans"), ctx.get("span_steps")
    if not spans or not steps:
        return None
    if name == "burst_host_ms_per_step":
        return _per_step_ms(spans, BURST, steps)
    if name == "burst_host_us_per_substep":
        ns = [s.end_ns - s.start_ns for s in spans if s.name == SUBSTEP]
        return sum(ns) / 1e3 / len(ns) if ns else None
    if name == "dg_ops_host_ms_per_step":
        ns = [s.end_ns - s.start_ns for s in spans
              if s.name.startswith("stage.") and s.name != BURST]
        return sum(ns) / 1e6 / steps if ns else None
    if name == "mass_solve_host_ms_per_step":
        return _per_step_ms(spans, MASS_SOLVE, steps)
    if name == "host_syncs_per_step":
        return sum(s.syncs for s in spans) / steps
    raise KeyError(name)


METRICS = ("burst_host_ms_per_step", "burst_host_us_per_substep",
           "dg_ops_host_ms_per_step", "mass_solve_host_ms_per_step",
           "host_syncs_per_step")


def table(spans: list, steps: int) -> dict:
    """{span name: calls, host ms and self ms a step, syncs} of ``spans``."""
    from repro_torch.obs.trace import self_ns
    out = {}
    for s, own in zip(spans, self_ns(spans)):
        row = out.setdefault(s.name, {"calls": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "syncs": 0})
        row["calls"] += 1
        row["host_ms"] += (s.end_ns - s.start_ns) / 1e6 / steps
        row["self_ms"] += own / 1e6 / steps
        row["syncs"] += s.syncs
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["host_ms"]))


def substeps_in_order(spans: list) -> dict:
    """{sub-steps a burst: mean host ms of its 1st, 2nd, ... sub-step} over
    the bursts of ``spans``: where in a burst the host's time goes."""
    bursts = {}
    for i, s in enumerate(spans):
        if s.name == BURST:
            bursts[i] = []
    for s in spans:
        if s.name == SUBSTEP and s.parent in bursts:
            bursts[s.parent].append((s.end_ns - s.start_ns) / 1e6)
    by_m = {}
    for subs in bursts.values():
        by_m.setdefault(len(subs), []).append(subs)
    return {m: [sum(col) / len(col) for col in zip(*runs)]
            for m, runs in sorted(by_m.items())}


def innermost(spans: list, times: list) -> list:
    """The name of the innermost span open at each of ``times`` (ns, on the
    spans' clock), or OUTSIDE.  Spans nest: a child lies inside its parent."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns,
                                                     -spans[i].end_ns))
    out = [OUTSIDE] * len(times)
    stack, j = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(order) and spans[order[j]].start_ns <= t:
            s = spans[order[j]]
            while stack and stack[-1].end_ns < s.start_ns:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        if stack:
            out[k] = stack[-1].name
    return out


def last_steps(spans: list, n: int) -> list:
    """The spans of the last ``n`` ``ocean.step`` roots of ``spans``."""
    roots = [i for i, s in enumerate(spans)
             if s.name == "ocean.step" and s.parent < 0][-n:]
    keep = set(roots)
    return [s for s in spans if s.step in keep]


def _top(d: dict, scale: float) -> list:
    return [[n, v / scale] for n, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def by_span(tr, spans: list) -> dict:
    """The profiled steps' idle gaps (s, summed by the innermost span open
    on the host at each gap's start) and kernels (launches a step, by the
    innermost span open at each launch): the top 10 of each."""
    gaps = tr.gaps()
    gap_by, launch_by = {}, {}
    for name, (_, length) in zip(innermost(spans, [t for t, _ in gaps]),
                                 gaps):
        gap_by[name] = gap_by.get(name, 0) + length
    kernels = [op.launched_ns for op in tr.ops
               if op.kernel and op.launched_ns >= 0]
    for name in innermost(spans, kernels):
        launch_by[name] = launch_by.get(name, 0) + 1
    return {"idle_gaps_by_span": _top(gap_by, 1e9),
            "launches_by_span": _top(launch_by, tr.steps)}


def clock_check(tr, spans: list) -> dict:
    """Profiler range start less the recorder span's start, paired by name
    and order (us): median, least and largest, and the pairs counted."""
    diffs = []
    for name, ranges in tr.ranges.items():
        mine = [s.start_ns for s in spans if s.name == name]
        if len(mine) == len(ranges):
            diffs += [(a - b) / 1e3 for (a, _), b in zip(sorted(ranges), mine)]
    if not diffs:
        return {"pairs": 0}
    return {"pairs": len(diffs), "median_us": statistics.median(diffs),
            "min_us": min(diffs), "max_us": max(diffs)}


def _leaves(st) -> list:
    """The tensors of an `OceanState`, its external state's among them."""
    return [*(getattr(st.ext, f.name) for f in dataclasses.fields(st.ext)),
            *(getattr(st, f.name) for f in dataclasses.fields(st)
              if f.name != "ext")]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def run(workload: str, seed: int, rounds: int, device: torch.device,
        overrides: dict = None) -> dict:
    """The measurement of the module docstring, as a dict.  The set-up is
    `harness.run_cell`'s, which has no part of its own to call."""
    port = sides.port_modules()
    from repro_torch.obs import trace
    wl = spec.workload(workload)
    case = dict(spec.config(wl["config"]))
    traffic = dict(spec.traffic(wl["traffic"]))
    for key, value in (overrides or {}).items():
        (traffic if key in traffic else case)[key] = value
    inp = inputs.make_inputs(case, traffic, seed, device)
    prog = sides.build(port, inp, getattr(torch, case["dtype"]), device)
    st = prog.state
    for _ in range(harness.WARM_STEPS):
        st = prog.advance(st)
    harness.sync(device)

    plain = prog.advance(st)
    with trace.recording():
        recorded = prog.advance(st)
    trace.drain()
    same = _equal(plain, recorded)
    st = recorded
    del plain
    harness.sync(device)

    windows, spans, syncs, covered = [], [], {}, []
    for _ in range(rounds):
        for on in (False, True):
            with trace.recording() if on else contextlib.nullcontext():
                t0 = time.time_ns()
                for _ in range(SPAN_STEPS):
                    st = prog.advance(st)
                t1 = time.time_ns()
                harness.sync(device)
                t2 = time.time_ns()
            windows.append({"recording": on,
                            "wall_ms_per_step": (t2 - t0) / 1e6 / SPAN_STEPS})
            if on:
                for k, v in trace.sync_counts().items():
                    syncs[k] = syncs.get(k, 0) + v
                got = trace.drain()
                windows[-1]["syncs"] = sum(s.syncs for s in got)
                steps_ns = sum(s.end_ns - s.start_ns for s in got
                               if s.name == "ocean.step")
                stages_ns = sum(s.end_ns - s.start_ns for s in got
                                if s.name.startswith("stage."))
                covered.append({"steps_of_host": steps_ns / (t1 - t0),
                                "stages_of_steps": stages_ns / steps_ns})
                base = len(spans)     # one list: parents and steps re-based
                spans += [sp._replace(parent=sp.parent + base if sp.parent >= 0
                                      else -1, step=sp.step + base)
                          for sp in got]
    steps = rounds * SPAN_STEPS
    ctx = {"spans": spans, "span_steps": steps}

    with trace.recording():
        st, tr, _ = harness._traced(prog, st, device)
        traced = last_steps(trace.drain(), tr.steps)
    off = [w["wall_ms_per_step"] for w in windows if not w["recording"]]
    on = [w["wall_ms_per_step"] for w in windows if w["recording"]]
    return {
        "workload": workload, "seed": seed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "power_limit_w": (harness.power_limit_w()
                          if device.type == "cuda" else None),
        "torch": torch.__version__, "recording_changes_no_bit": same,
        "metrics": {m: read(m, ctx) for m in METRICS},
        "syncs": syncs, "windows": windows,
        "recording_cost": statistics.median(b / a - 1
                                            for a, b in zip(off, on)),
        "coverage": covered,
        "spans": table(spans, steps),
        "substeps_in_order_ms": substeps_in_order(spans),
        "traced": {"steps": tr.steps, "window_s": tr.window_s,
                   "launches_per_step": sum(op.kernel for op in tr.ops)
                   / tr.steps,
                   "clock": clock_check(tr, traced), **by_span(tr, traced)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    # importing bench.run keeps the build caches inside the checkout
    from . import run as _run  # noqa: F401
    if not torch.cuda.is_available():
        print("no CUDA device: the spans are measured on the card only",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.rounds, torch.device("cuda", 0))
    line = json.dumps(out)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
