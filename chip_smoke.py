#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 160,000 triangles x 16 layers

Phases (each prints its own lines; any failure raises and exits non-zero):

  1. device   — the card's name and power limit;
  2. build    — compiles src/repro_torch/csrc/ocean_kernels.cu with nvcc and
                prints the registers / spills `-Xptxas -v` reports;
  3. kernels  — each CUDA kernel (K1 solve_r, K2 solve_w, K3 block_thomas,
                K4 lateral_flux) against its plain PyTorch version at the
                main path's shapes, in float32 and float64, from seeded numpy
                inputs, with CUDA-event times against the memory bound;
  4. main path — 3 steps of the quickstart's baroclinic-front case widened to
                rect_mesh(400, 200) (~333 m cells, 160,000 triangles, 16
                layers; 20 external sub-steps, which the setup picks for
                this mesh's thinnest triangle) through the cuda backend,
                with the launch counters read just after; then the same 3
                steps through the plain backend on the card, which must
                agree; then 10 more cuda steps, timed for the steady
                ms/step.  Run in float32 and again in float64.

The line before the last is the card's `nvidia-smi` name and power limit;
the line before that is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {torch.float32: 67e12,  # H100 SXM vector peaks, no tensor cores
              torch.float64: 34e12}  # (NVIDIA data sheet)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# cuda vs plain backend after the main path's 3 steps; the two differ only
# in summation order.  float64: every field within 1e-8 of its own maximum.
# float32: the temperature and salinity within 1e-4 * max(|x|_inf, 1); the
# other fields are printed, not held to a tolerance, because in float32
# this case does not reproduce across summation orders, in the JAX
# reference as in the port (tests/test_torch_f32_spread.py): rho' = rho -
# rho0 is formed in float32, N^2 is its difference across a 1.25 m layer,
# and the GLS closure turns that noise into differences of several percent
# in eps and nu_t within one step, which reach the velocities through nu_t.
TOL_PATH = {torch.float32: 1e-4, torch.float64: 1e-8}
HELD_F32 = ("T", "S")
SOURCE = "src/repro_torch/csrc/ocean_kernels.cu"
REPLACES = {
    "solve_r": "src/repro/kernels/matrix_free.py:103",
    "solve_w": "src/repro/kernels/matrix_free.py:114",
    "block_thomas": "src/repro/kernels/column_solve.py:90",
    "lateral_flux": "src/repro/kernels/horizontal_flux.py:96",
}
PER_STEP = {"solve_r": 2, "solve_w": 2, "block_thomas": 2, "lateral_flux": 4}
NX, NL = 400, 16      # rect_mesh(400, 200): 160,000 triangles x 16 layers
STEPS = 3             # counted steps of the main path, compared with plain
TIMED_STEPS = 10      # further steps, timed for the steady ms/step
SEED = 0              # kernel-phase inputs


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: build report
# ---------------------------------------------------------------------------
def ptxas_summary(report: str) -> dict:
    """{kernel variant: {registers, spill_stores, spill_loads}} from the
    `-Xptxas -v` report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = m.group(1)
            k = re.search(r"\d+([a-z_]+?)_kernelI([fd])(?:Li(\d)E)?", name)
            if k:
                cur = f"{k.group(1)}_{'f32' if k.group(2) == 'f' else 'f64'}"
                if k.group(3):
                    cur += f"_k{k.group(3)}"
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_cases(nt: int, nl: int, seed: int):
    """(name, label, kernel fn, plain fn, inputs builder, flops) per case;
    the builder turns a dtype into the inputs on the card."""
    from repro_torch.kernels import column_solve, horizontal_flux, matrix_free
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s, dtype=np.float32)
    F2, bc2 = r(2, nl, 6, nt), r(2, 3, nt)
    F1 = r(1, nl, 6, nt)
    area = (0.5 + rng.random(nt, dtype=np.float32)) * 1e5
    blk = [0.1 * r(nl, 6, 6, nt) for _ in range(3)]
    blk[0][0] = 0.0
    blk[2][-1] = 0.0
    blk[1] += 2.0 * np.eye(6, dtype=np.float32)[None, :, :, None]
    rhs = r(2, nl, 6, nt)
    f4, fext4 = r(4, nl, 6, nt), r(4, nl, 3, 2, 2, nt)
    speed = r(nl, 2, 3, 2, nt)
    elen = (0.5 + rng.random((3, nt), dtype=np.float32)) * 300.0

    def on(dtype, *arrs):
        return [torch.as_tensor(a).to(device="cuda", dtype=dtype) for a in arrs]

    def bt_flops(k):
        per_layer = 36 * 13 + 6 * k * 13 + 6 * (133 + 11 * k)
        return nt * (nl * per_layer + (nl - 1) * 6 * k * 13)

    return [
        ("solve_r", "K=2", matrix_free.solve_r, matrix_free.solve_r_plain,
         lambda d: on(d, F2, area, bc2), 2 * nt * (nl * 34 + 1)),
        ("solve_w", "K=1", lambda F, a: matrix_free.solve_w(F, a),
         lambda F, a: matrix_free.solve_w_plain(F, a),
         lambda d: on(d, F1, area), 1 * nt * (nl * 34 + 1)),
        ("block_thomas", "k=2", column_solve.block_thomas,
         column_solve.block_thomas_plain,
         lambda d: on(d, *blk, rhs), bt_flops(2)),
        ("lateral_flux", "k=2", horizontal_flux.lateral_flux,
         horizontal_flux.lateral_flux_plain,
         lambda d: on(d, f4[:2], fext4[:2], speed, elen), 2 * nl * nt * 300),
        ("lateral_flux", "k=4", horizontal_flux.lateral_flux,
         horizontal_flux.lateral_flux_plain,
         lambda d: on(d, f4, fext4, speed, elen), 4 * nl * nt * 300),
    ]


def phase_kernels(nt: int, nl: int, seed: int) -> dict:
    results = {}
    for name, label, kern, plain, build_inputs, flops in kernel_cases(nt, nl, seed):
        for dtype in (torch.float32, torch.float64):
            ins = build_inputs(dtype)
            out = kern(*ins)
            torch.cuda.synchronize()
            ref = plain(*ins)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = max(float(ref.abs().max()), 1.0)
            if not (err <= TOL[dtype] * scale):
                raise AssertionError(f"{name} {label} {dtype}: max_abs_err {err:.3e}"
                                     f" > {TOL[dtype]:.0e} * {scale:.3e}")
            ms = time_ms(lambda: kern(*ins), reps=20)
            plain_ms = time_ms(lambda: plain(*ins), reps=3, warmup=1)
            moved = nbytes(*ins, out)
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            bound = max(t_bytes, t_ops)
            dt = "f32" if dtype == torch.float32 else "f64"
            log(f"kernel {name} {label} {dt}: shape={tuple(ins[0].shape)} "
                f"max_abs_err={err:.3e} (tol {TOL[dtype]:.0e} x {scale:.3e}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.3f} bytes={moved} "
                f"flops={flops} bound_ms={bound:.4f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
                f"share_of_bound={bound / ms:.3f}")
            results[(name, label, dt)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved, flops=flops, shape=list(ins[0].shape))
            del ins, out, ref
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def run_steps(geom, vg, cfg, st, steps):
    from repro_torch.core import stepper
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = stepper.step(geom, vg, cfg, st)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return st, times


FIELDS = {"ux": lambda s: s.ux, "uy": lambda s: s.uy, "T": lambda s: s.T,
          "S": lambda s: s.S, "eta": lambda s: s.ext.eta,
          "qx": lambda s: s.ext.qx, "qy": lambda s: s.ext.qy,
          "turb_k": lambda s: s.turb_k, "turb_eps": lambda s: s.turb_eps,
          "nu_t": lambda s: s.nu_t, "kappa_t": lambda s: s.kappa_t}


def compare_states(st_cuda, st_plain, dtype) -> dict:
    """cuda-vs-plain difference of every prognostic field, relative to the
    scale its tolerance uses (see TOL_PATH); raises on a non-finite value
    or a held field above its tolerance."""
    diffs = {}
    for name, get in FIELDS.items():
        a, b = get(st_cuda), get(st_plain)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite values on the cuda path")
        amax = float(a.abs().max())
        if dtype == torch.float64:
            scale = amax if amax > 0.0 else 1.0
        else:
            scale = max(amax, 1.0)
        rel = float((a - b).abs().max()) / scale
        diffs[name] = rel
        held = dtype == torch.float64 or name in HELD_F32
        if held and not rel <= TOL_PATH[dtype]:
            raise AssertionError(f"{name} ({dtype}): cuda vs plain {rel:.3e} "
                                 f"> {TOL_PATH[dtype]}")
    return diffs


def phase_main_path(dtype) -> dict:
    """STEPS steps of the quickstart case through the cuda backend (counted),
    then through the plain backend from the same state, which must agree;
    then TIMED_STEPS more cuda steps for the steady step time."""
    import dataclasses
    from repro_torch import quickstart
    from repro_torch.kernels import dispatch, ops

    t0 = time.perf_counter()
    geom, vg, cfg, st0 = quickstart.setup(nx=NX, nl=NL, dtype=dtype,
                                          device="cuda")
    torch.cuda.synchronize()
    log(f"main path: {geom.nt} triangles x {NL} layers "
        f"({geom.nt * NL} prisms), {dtype}, dt={cfg.dt}s, m_2d={cfg.m_2d}; "
        f"setup {time.perf_counter() - t0:.1f}s")
    if dispatch.resolve(cfg.backend, geom.area.device) is not dispatch.Backend.CUDA:
        raise AssertionError("backend auto did not resolve to cuda")
    heat0 = quickstart.heat_content(geom, vg, st0, cfg)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    st_cuda, times = run_steps(geom, vg, cfg, st0, STEPS)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {(op, "cuda"): STEPS * n for op, n in PER_STEP.items()}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    log(f"main path cuda: launches {sorted(launches.items())}")

    cfg_plain = dataclasses.replace(cfg, backend="plain")
    st_plain, times_plain = run_steps(geom, vg, cfg_plain, st0, STEPS)
    diffs = compare_states(st_cuda, st_plain, dtype)
    heat = quickstart.heat_content(geom, vg, st_cuda, cfg)
    drift = abs(heat - heat0) / abs(heat0)
    if not drift <= 1e-5:
        raise AssertionError(f"heat drift {drift:.3e} > 1e-5")
    if not float(st_cuda.ux.abs().max()) > 0.0:
        raise AssertionError("no flow developed")
    st_end, steady = run_steps(geom, vg, cfg, st_cuda, TIMED_STEPS)
    if not bool(torch.isfinite(st_end.ux).all()):
        raise AssertionError(f"non-finite ux after {STEPS + TIMED_STEPS} steps")
    ms = float(np.mean(steady)) * 1e3
    res = dict(ms_per_step=ms, ms_min=min(steady) * 1e3,
               ms_max=max(steady) * 1e3, first_step_ms=times[0] * 1e3,
               physical_over_wall=cfg.dt / (ms / 1e3), peak_bytes=peak,
               rel_diff_vs_plain=diffs, heat_drift=drift, launches=launches)
    log(f"main path cuda {dtype}: counted steps "
        f"{[round(t * 1e3, 2) for t in times]} ms; {TIMED_STEPS} steady steps "
        f"{[round(t * 1e3, 2) for t in steady]} ms: mean {ms:.2f} "
        f"(min {res['ms_min']:.2f}, max {res['ms_max']:.2f}) ms/step; "
        f"physical/wall {res['physical_over_wall']:.1f}; peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} bytes)")
    log(f"main path plain {dtype}: step times "
        f"{[round(t * 1e3, 2) for t in times_plain]} ms; cuda vs plain "
        f"{ {k: float(f'{v:.3e}') for k, v in diffs.items()} }; heat drift "
        f"{drift:.3e}; max|u| {float(st_cuda.ux.abs().max()):.4e}")
    del geom, vg, st0, st_cuda, st_plain, st_end
    torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import cuda_lib

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; count {torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    so = cuda_lib.build()
    cuda_lib.library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f}s "
        f"({' '.join(cuda_lib.NVCC_FLAGS)})")
    for variant, info in sorted(ptxas_summary(cuda_lib.ptxas_report()).items()):
        log(f"ptxas {variant}: {info}")

    # 3. kernels at the main path's shapes
    kres = phase_kernels(2 * NX * (NX // 2), NL, SEED)

    # 4. main path: float32 (the run the kernel table's launches come from),
    # then float64, where every field is held to TOL_PATH
    mres = phase_main_path(torch.float32)
    phase_main_path(torch.float64)

    table = []
    for name in PER_STEP:
        label = {"solve_r": "K=2", "solve_w": "K=1", "block_thomas": "k=2",
                 "lateral_flux": "k=4"}[name]
        r32, r64 = kres[(name, label, "f32")], kres[(name, label, "f64")]
        table.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=mres["launches"][(name, "cuda")],
            max_abs_err=r32["max_abs_err"], ms=r32["ms"],
            plain_ms=r32["plain_ms"], bound_ms=r32["bound_ms"],
            bound_by=r32["bound_by"], library_ms=None,
            dtype="float32", shape=r32["shape"], case=label,
            ms_f64=r64["ms"], bound_ms_f64=r64["bound_ms"],
            max_abs_err_f64=r64["max_abs_err"]))
    print(json.dumps({"kernels": table}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
