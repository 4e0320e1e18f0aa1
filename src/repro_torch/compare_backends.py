"""How far the kernel backends' trajectories drift apart: ``--steps`` steps
of the quickstart case through every backend the device has (cuda, plain
and ref on the card; plain and ref on the CPU) from one state, and for each
pair of backends and each step the largest difference of every prognostic
field relative to that field's maximum.

    PYTHONPATH=src python -m repro_torch.compare_backends [--nx 400] [--nl 16]
        [--steps 3] [--dtype float32|float64] [--device cuda|cpu]

The backends differ only in summation order, so the spread measures how
strongly the model amplifies rounding in the chosen precision.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import torch

from . import quickstart
from .core import stepper

FIELDS = ("ux", "uy", "T", "S", "turb_k", "turb_eps", "nu_t", "kappa_t")


def _field(st, name):
    return st.ext.eta if name == "eta" else getattr(st, name)


def compare(nx: int, nl: int, steps: int, dtype, device=None) -> dict:
    geom, vg, cfg, st0 = quickstart.setup(nx=nx, nl=nl, dtype=dtype,
                                          device=device)
    on_card = geom.area.device.type == "cuda"
    backends = ("cuda", "plain", "ref") if on_card else ("plain", "ref")
    traj, ms = {}, {}
    for bk in backends:
        c = dataclasses.replace(cfg, backend=bk)
        st, states = st0, []
        t0 = time.perf_counter()
        for _ in range(steps):
            st = stepper.step(geom, vg, c, st)
            states.append(st)
        if on_card:
            torch.cuda.synchronize()
        ms[bk] = (time.perf_counter() - t0) / steps * 1e3
        traj[bk] = states
    rel = {}
    for a, b in itertools.combinations(backends, 2):
        rel[f"{a}-{b}"] = [
            {f: float((_field(sa, f) - _field(sb, f)).abs().max())
             / max(float(_field(sa, f).abs().max()), 1e-30)
             for f in FIELDS + ("eta",)}
            for sa, sb in zip(traj[a], traj[b])]
    return dict(device=str(geom.area.device), nt=geom.nt, nl=nl,
                dtype=str(dtype), steps=steps, ms_per_step=ms,
                rel_diff=rel)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--nl", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    res = compare(args.nx, args.nl, args.steps, getattr(torch, args.dtype),
                  args.device)
    print(f"{res['nt']} triangles x {res['nl']} layers, {res['dtype']} on "
          f"{res['device']}; ms/step (first step included): "
          f"{ {k: round(v, 1) for k, v in res['ms_per_step'].items()} }")
    for pair, per_step in res["rel_diff"].items():
        for i, row in enumerate(per_step):
            print(f"{pair} step {i + 1}: "
                  + " ".join(f"{k}={v:.1e}" for k, v in row.items()))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
