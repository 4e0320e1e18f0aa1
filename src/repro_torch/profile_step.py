"""Where a step's time goes on the card: one profiled step of the quickstart
case (or of the GBR case at `gbr_reef.FULL_SIZE`, with its forcing), with
device kernel time summed by name.

    PYTHONPATH=src python -m repro_torch.profile_step [--nx 400] [--nl 16]
        [--case quickstart|gbr] [--dtype float32|float64] [--json-out FILE]

Prints the wall time of the profiled step (host clock, ending in
`torch.cuda.synchronize()`), the device time summed over every kernel, the
device's idle share of the step (1 - device time / wall time), the number of
kernel launches, and the kernels that took most device time.  Then the
stage table: for each range the stepper opens (`imex.stage1/2`, `stage.*`;
see `obs/trace.py`), the device time of the kernels launched inside it and
their number, summed over the step's two stages.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from . import gbr_reef, quickstart
from .core import stepper

# the port's own kernels, by the names their templates compile to
OWN_KERNELS = ("solve_r_kernel", "solve_w_kernel", "block_thomas_kernel",
               "lateral_flux_kernel", "soa_to_cell_kernel",
               "cell_to_soa_kernel", "tridiag_kernel")
# the ranges of core/stepper.py, in the order a stage runs them
SCOPES = ("imex.stage1", "imex.stage2", "stage.edge_cache",
          "stage.pressure_gradient", "stage.flux_prediction",
          "stage.external_burst", "stage.turbulence", "stage.w_solve",
          "stage.horizontal_rhs", "stage.momentum_update",
          "stage.tracer_update", "stage.turbulence_final")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# the profiler also puts each range of obs/trace.py on the device timeline,
# under the range's own name: those are not kernels
RANGE_PREFIXES = ("imex.", "stage.", "kops.", "obs.")


def _is_kernel(name: str) -> bool:
    return not name.startswith(RANGE_PREFIXES)


def stage_table(events) -> list:
    """One row per range of SCOPES: the host events of that name in the
    profile (``calls``), their host wall ms, and the device ms and number
    of the kernels launched inside them.

    A kernel is linked to the runtime call that launched it (``cu*`` host
    events share the kernel's CUPTI correlation id) and counted in every
    range whose host interval holds that call.  This does not use the
    profiler's own kernel-to-operator tree, which in a float64 step put
    more launches under the ranges than the step made."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    launched_at, ranges, kernels = {}, [], []
    for e in events:
        if e.device_type == cpu:
            if e.name.startswith("cu"):
                launched_at[e.id] = e.time_range.start
            elif e.name in SCOPES:
                ranges.append(e)
        elif (e.device_type == cuda and _is_kernel(e.name)
              and not getattr(e, "is_user_annotation", False)):
            kernels.append(e)
    rows = {name: dict(scope=name, calls=0, host_ms=0.0, device_ms=0.0,
                       launches=0)
            for name in SCOPES}
    for r in ranges:
        rows[r.name]["calls"] += 1
        rows[r.name]["host_ms"] += r.time_range.elapsed_us() / 1e3
    for k in kernels:
        t = launched_at.get(k.id)
        if t is None:
            continue
        for r in ranges:
            if r.time_range.start <= t <= r.time_range.end:
                rows[r.name]["device_ms"] += k.time_range.elapsed_us() / 1e3
                rows[r.name]["launches"] += 1
    return list(rows.values())


def profile_step(nx: int, nl: int, dtype, top: int = 25,
                 case: str = "quickstart") -> dict:
    """One profiled step after a warm-up one; ``case="gbr"`` runs the GBR
    case at `gbr_reef.FULL_SIZE` (nx, nl unused)."""
    from torch.profiler import ProfilerActivity, profile
    if case == "gbr":
        geom, vg, cfg, st, forcing_at, _ = gbr_reef.full_size_setup(dtype)
        nl = cfg.nl
    else:
        geom, vg, cfg, st = quickstart.setup(nx=nx, nl=nl, dtype=dtype)
        forcing_at = lambda t: stepper.Forcing3D()
    st = stepper.step(geom, vg, cfg, st, forcing_at(st.time))   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = stepper.step(geom, vg, cfg, st, forcing_at(st.time))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and _is_kernel(e.key)]
    kernels.sort(key=_device_us, reverse=True)
    device_us = sum(_device_us(e) for e in kernels)
    launches = sum(int(e.count) for e in kernels)
    own_us = sum(_device_us(e) for e in kernels
                 if any(k in e.key for k in OWN_KERNELS))
    return dict(
        device=torch.cuda.get_device_name(0), case=case, nt=geom.nt, nl=nl,
        m_2d=cfg.m_2d,
        dtype=str(dtype), wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
        idle_share=1.0 - device_us / wall_us, kernel_launches=launches,
        own_kernels_ms=own_us / 1e3, stages=stage_table(prof.events()),
        top=[dict(name=e.key[:120], count=int(e.count),
                  device_ms=_device_us(e) / 1e3) for e in kernels[:top]])


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--nl", type=int, default=16)
    ap.add_argument("--case", choices=("quickstart", "gbr"),
                    default="quickstart")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    res = profile_step(args.nx, args.nl, getattr(torch, args.dtype),
                       case=args.case)
    print(f"{res['device']}: {res['case']}, {res['nt']} triangles x "
          f"{res['nl']} layers, m_2d {res['m_2d']}, "
          f"{res['dtype']}: step wall {res['wall_ms']:.3f} ms, device "
          f"{res['device_ms']:.3f} ms (idle share {res['idle_share']:.3f}), "
          f"{res['kernel_launches']} kernel launches, own kernels "
          f"{res['own_kernels_ms']:.3f} ms")
    for row in res["top"]:
        print(f"  {row['device_ms']:9.3f} ms  {row['count']:5d}x  {row['name']}")
    covered = sum(r["launches"] for r in res["stages"]
                  if r["scope"].startswith("imex."))
    print("by range, summed over the step's two stages (host wall ms under "
          f"the profiler, device ms, launches; the two imex ranges cover "
          f"{covered} of the step's {res['kernel_launches']} launches):")
    for row in res["stages"]:
        print(f"  {row['host_ms']:9.3f} ms  {row['device_ms']:9.3f} ms  "
              f"{row['launches']:6d}  {row['calls']}x  {row['scope']}")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
