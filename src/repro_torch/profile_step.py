"""Where a step's time goes on the card: one profiled step of the quickstart
case, with device kernel time summed by name.

    PYTHONPATH=src python -m repro_torch.profile_step [--nx 400] [--nl 16]
        [--dtype float32|float64] [--json-out FILE]

Prints the wall time of the profiled step (host clock, ending in
`torch.cuda.synchronize()`), the device time summed over every kernel, the
device's idle share of the step (1 - device time / wall time), the number of
kernel launches, and the kernels that took most device time.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from . import quickstart
from .core import stepper

# the port's own kernels, by the names their templates compile to
OWN_KERNELS = ("solve_r_kernel", "solve_w_kernel", "block_thomas_kernel",
               "lateral_flux_kernel")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_step(nx: int, nl: int, dtype, top: int = 25) -> dict:
    from torch.profiler import ProfilerActivity, profile
    geom, vg, cfg, st = quickstart.setup(nx=nx, nl=nl, dtype=dtype)
    st = stepper.step(geom, vg, cfg, st)            # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = stepper.step(geom, vg, cfg, st)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    device_us = sum(_device_us(e) for e in kernels)
    launches = sum(int(e.count) for e in kernels)
    own_us = sum(_device_us(e) for e in kernels
                 if any(k in e.key for k in OWN_KERNELS))
    return dict(
        device=torch.cuda.get_device_name(0), nt=geom.nt, nl=nl,
        dtype=str(dtype), wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
        idle_share=1.0 - device_us / wall_us, kernel_launches=launches,
        own_kernels_ms=own_us / 1e3,
        top=[dict(name=e.key[:120], count=int(e.count),
                  device_ms=_device_us(e) / 1e3) for e in kernels[:top]])


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--nl", type=int, default=16)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    res = profile_step(args.nx, args.nl, getattr(torch, args.dtype))
    print(f"{res['device']}: {res['nt']} triangles x {res['nl']} layers, "
          f"{res['dtype']}: step wall {res['wall_ms']:.3f} ms, device "
          f"{res['device_ms']:.3f} ms (idle share {res['idle_share']:.3f}), "
          f"{res['kernel_launches']} kernel launches, own kernels "
          f"{res['own_kernels_ms']:.3f} ms")
    for row in res["top"]:
        print(f"  {row['device_ms']:9.3f} ms  {row['count']:5d}x  {row['name']}")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
