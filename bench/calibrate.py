"""Readings from which the comparison's limits are set (not run by the
benchmark's own runs): for each seed, the plain float64 reference over
``--steps`` steps, then the program (its step on the card, no window) and
the control (the reference in float32, the precision below the
configuration's) over the same steps from the same inputs, each held to
the float64 reference by `compare.gaps`.

    python3 -m bench.calibrate --workload <cell> --seeds 1,2,3 --steps <n>
        [--sides program,control]

prints one JSON line per seed and side.
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from . import compare, inputs, sides, spec


def run_side(mods, inp, dtype, device, steps: int) -> dict:
    side = sides.build(mods, inp, dtype, device)
    st = side.state
    for _ in range(steps):
        st = side.advance(st)
    out = {k: v.to(torch.float64) for k, v in compare.fields(st).items()}
    del side, st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--sides", default="program,control")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    wl = spec.workload(args.workload)
    case, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    dtype = getattr(torch, case["dtype"])
    below = {torch.float64: torch.float32}[dtype]
    for seed in (int(s) for s in args.seeds.split(",")):
        inp = inputs.make_inputs(case, traffic, seed, device)
        t0 = time.perf_counter()
        ref = run_side(sides.reference_modules(), inp, dtype, device,
                       args.steps)
        t_ref = time.perf_counter() - t0
        for name in args.sides.split(","):
            mods, dt = {"program": (sides.port_modules(), dtype),
                        "control": (sides.reference_modules(), below)}[name]
            t0 = time.perf_counter()
            try:
                got = run_side(mods, inp, dt, device, args.steps)
                gap = compare.gaps(got, ref)
            except RuntimeError as exc:       # a control that crashes fails
                gap = {"error": str(exc)[:200]}
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": name, "steps": args.steps,
                              "reference_s": t_ref,
                              "side_s": time.perf_counter() - t0,
                              "gaps": gap}), flush=True)


if __name__ == "__main__":
    main()
