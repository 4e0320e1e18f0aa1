"""Quickstart: 3D baroclinic adjustment in a closed basin, on the card.

Sets up an unstructured basin (cells of ~333 m, jittered) with a temperature
front at lx/2, runs the full split-IMEX 3D model (external mode bursts,
implicit vertical solves, GLS turbulence) and prints conservation/energy
diagnostics every few steps.

    PYTHONPATH=src python -m repro_torch.quickstart [--steps 30] [--nl 6] [--nx 12]
        [--dtype float32|float64] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from .core import geometry, mesh2d, stepper, vertical
from .core.extrusion import VGrid, layer_geometry
from .kernels.dispatch import default_device

CELL_M = 4000.0 / 12     # horizontal cell size of the quickstart basin [m]
DEPTH_M = 20.0           # basin depth [m]
EXT_COURANT_MAX = 1.1    # largest external-mode Courant number used


def external_substeps(mesh: mesh2d.Mesh2D, dt: float,
                      depth: float = DEPTH_M) -> int:
    """External-mode sub-steps per internal step: the reference
    quickstart's 10, doubled until the gravity-wave Courant number
    sqrt(g depth) (dt / m_2d) / r_min on the thinnest triangle (inscribed
    radius r_min) is at most EXT_COURANT_MAX.  The 2D burst is explicit, and
    a larger jittered mesh has a thinner worst triangle: 1.04 ran stably for
    16 steps on rect_mesh(100, 50), 1.2 blew up within 5 on
    rect_mesh(400, 200) (see tests/test_torch_external_cfl.py).  A case
    with varying depth passes its deepest point."""
    p, area = mesh.node_xy(), mesh.areas()
    perim = sum(np.linalg.norm(p[:, (i + 1) % 3] - p[:, i], axis=1)
                for i in range(3))
    r_min = float((2.0 * area / perim).min())
    c = math.sqrt(geometry.G_GRAV * depth)
    m_2d = 10
    while c * dt / m_2d / r_min > EXT_COURANT_MAX:
        m_2d *= 2
    return m_2d


def basin_mesh(nx: int = 12) -> mesh2d.Mesh2D:
    """The basin of `setup`: rect_mesh(nx, nx/2) of CELL_M cells, jittered."""
    return mesh2d.rect_mesh(nx, nx // 2, nx * CELL_M, (nx // 2) * CELL_M,
                            jitter=0.2, seed=1)


def setup(nx: int = 12, nl: int = 6, dtype=torch.float32, device=None):
    """The baroclinic-front case: rect_mesh(nx, nx/2) of ~333 m cells
    (2 nx^2/2 triangles), 20 m deep, nl layers, warm water on the left half,
    dt = 30 s with `external_substeps` external sub-steps.

    Returns (geom, vg, cfg, state)."""
    device = default_device(device)
    lx = nx * CELL_M
    m = basin_mesh(nx)
    geom = geometry.geom2d_from_mesh(m, dtype=dtype, device=device)
    vg = VGrid(b=torch.full((3, m.nt), DEPTH_M, dtype=dtype, device=device),
               nl=nl)
    cfg = stepper.OceanConfig(nl=nl, dt=30.0, m_2d=external_substeps(m, 30.0),
                              eos_kind="linear", use_gls=True, coriolis_f=1e-4)
    st = stepper.init_state(geom, vg)
    # warm water on the left: the front slumps into a baroclinic circulation
    Tf = 10.0 + 4.0 * torch.tanh((lx / 2 - geom.node_x) / 400.0)
    T = torch.cat([Tf, Tf])[None].expand(st.T.shape).contiguous()
    return geom, vg, cfg, dataclasses.replace(st, T=T)


def heat_content(geom, vg, st, cfg) -> float:
    """Total heat content sum(M T), accumulated in float64."""
    vge = layer_geometry(vg, st.ext.eta, cfg.h_min)
    return float(vertical.mass_apply3d(geom, vge.jz, st.T)
                 .sum(dtype=torch.float64))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--nl", type=int, default=6)
    ap.add_argument("--nx", type=int, default=12)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    geom, vg, cfg, st = setup(args.nx, args.nl, getattr(torch, args.dtype),
                              args.device)
    sync = (torch.cuda.synchronize if geom.area.device.type == "cuda"
            else (lambda: None))
    heat0 = heat_content(geom, vg, st, cfg)
    print(f"mesh: {geom.nt} triangles x {args.nl} layers "
          f"({geom.nt * args.nl} prisms) on {geom.area.device}; "
          f"dt={cfg.dt}s, m={cfg.m_2d}")
    print(f"{'step':>5} {'t[s]':>7} {'max|u|':>9} {'max|eta|':>9} "
          f"{'KE':>12} {'heat drift':>11}")
    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
        st = stepper.step(geom, vg, cfg, st)
        if i % 5 == 0 or i == args.steps - 1:
            vge = layer_geometry(vg, st.ext.eta, cfg.h_min)
            ke = float(vertical.mass_apply3d(
                geom, vge.jz, 0.5 * (st.ux ** 2 + st.uy ** 2)).sum())
            heat = heat_content(geom, vg, st, cfg)
            print(f"{i:5d} {float(st.time):7.0f} "
                  f"{float(st.ux.abs().max()):9.5f} "
                  f"{float(st.ext.eta.abs().max()):9.5f} "
                  f"{ke:12.5e} {abs(heat - heat0) / heat0:11.2e}")
    sync()
    wall = time.perf_counter() - t0
    print(f"\n{args.steps} steps in {wall:.1f}s "
          f"({wall / args.steps * 1e3:.0f} ms/step, diagnostics included); "
          f"physical/wall ratio = {args.steps * cfg.dt / wall:.1f}")
    if not bool(torch.isfinite(st.ux).all()):
        raise SystemExit("NaN detected")
    print("OK: baroclinic circulation developed, heat conserved.")


if __name__ == "__main__":
    main()
