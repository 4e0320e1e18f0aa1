"""Great-Barrier-Reef-style case (paper §5, reduced scale), on the card.

Reef-belt bathymetry (shelf + gaussian reef bumps), an M2 tide at the open
offshore boundary, trade-wind stress, Coriolis, the Jackett EOS and GLS
turbulence: the full physics of the paper's GBR case on a synthetic mesh
(the real GBR inputs are not redistributable).  Reports the
physical-to-wall-clock ratio (the paper's headline metric: 100 at 3.3 M
triangles on 64 GPUs) and the percentiles of the surface vorticity (the
paper's Fig. 20 analogue).

    PYTHONPATH=src python -m repro_torch.gbr_reef [--steps 20] [--nx 24]
        [--nl 5] [--dtype float32|float64] [--device cuda|cpu]

`full_size_setup` builds the case at the resolution of the reference's
`gbr` dry-run cell, the size `chip_smoke.py` and `profile_step` run.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import numpy as np
import torch

from .core import dg2d, geometry, mesh2d, stepper
from .core.extrusion import VGrid
from .kernels.dispatch import default_device

LX, LY = 100e3, 60e3          # domain [m]; the open boundary is at x = LX
TIDE_AMP = 0.8                # M2-like tide on the open boundary [m]
TIDE_PERIOD = 44712.0         # [s]
TAU = (-5e-5, 3e-5)           # south-east trade wind stress / rho0 [m^2/s^2]
T_REEF, S_REEF = 24.0, 35.0   # initial and open-boundary temperature, salinity
CORIOLIS_F = -4e-5            # southern hemisphere
# the resolution of the reference's `gbr` dry-run cell
# (src/repro/launch/ocean_dryrun.py: cells of 2000 km / 1280 x 2600 km /
# 1290, 20 layers, dt 45 s, reef bathymetry from 12 to 120 m) on
# rect_mesh(400, 200): 160,000 triangles x 20 layers
FULL_SIZE = dict(nx=400, ny=200, lx=625e3, ly=403.1e3, nl=20,
                 depth_shallow=12.0, depth_deep=120.0, n_reefs=25, dt=45.0)
FULL_SIZE_M2D_MIN = 20        # the reference's m_2d


def surface_vorticity(geom: geometry.Geom2D, st: stepper.OceanState):
    """Per-triangle curl of the surface velocity, (nt,)."""
    us, vs = st.ux[0, 0:3, :], st.uy[0, 0:3, :]
    return geometry.grad2d(geom, vs)[0] - geometry.grad2d(geom, us)[1]


def reef_mesh(nx: int, ny: int, lx: float = LX,
              ly: float = LY) -> mesh2d.Mesh2D:
    """rect_mesh(nx, ny) of lx x ly, jitter 0.2, seed 5, with an open
    boundary at x = lx (the offshore side)."""
    def open_fn(mids):
        return mids[:, 0] > lx * (1 - 1e-9)
    return mesh2d.rect_mesh(nx, ny, lx, ly, jitter=0.2, seed=5,
                            open_edge_fn=open_fn)


def setup(nx: int = 24, nl: int = 5, lx: float = LX, ly: float = LY,
          depth_shallow: float = 8.0, depth_deep: float = 80.0,
          n_reefs: int = 25, dt: float = 40.0, m_2d: int = 20,
          dtype=torch.float32, device=None, ny: Optional[int] = None):
    """The reef case on `reef_mesh(nx, ny, lx, ly)` (ny = 3 nx / 5 unless
    given) with `mesh2d.reef_bathymetry(depth_shallow, depth_deep, lx, ly,
    n_reefs)`.

    Returns (geom, vg, cfg, st, forcing_at), forcing_at(time) giving the
    Forcing3D at that time (the tide varies, so a step takes it afresh)."""
    device = default_device(device)
    m = reef_mesh(nx, nx * 3 // 5 if ny is None else ny, lx, ly)
    geom = geometry.geom2d_from_mesh(m, dtype=dtype, device=device)
    bf = mesh2d.reef_bathymetry(depth_shallow, depth_deep, lx, ly,
                                n_reefs=n_reefs)
    # from the node coordinates in the run's dtype, as the reference does in
    # float32
    pts = np.stack([geom.node_x.cpu().numpy().ravel(),
                    geom.node_y.cpu().numpy().ravel()], 1)
    b = torch.as_tensor(bf(pts).reshape(3, m.nt), dtype=dtype, device=device)
    vg = VGrid(b=b, nl=nl)
    cfg = stepper.OceanConfig(nl=nl, dt=dt, m_2d=m_2d, eos_kind="jackett",
                              use_gls=True, coriolis_f=CORIOLIS_F)
    st = stepper.init_state(geom, vg, T0=T_REEF, S0=S_REEF)
    z = dict(dtype=dtype, device=device)
    tau_x = torch.full((3, m.nt), TAU[0], **z)
    tau_y = torch.full((3, m.nt), TAU[1], **z)
    T_open = torch.full((nl, 6, m.nt), T_REEF, **z)
    S_open = torch.full((nl, 6, m.nt), S_REEF, **z)

    def forcing_at(t) -> stepper.Forcing3D:
        """The tide at time t on the open boundary, the steady trade wind
        and the open-boundary tracers."""
        eta_bc = (TIDE_AMP * torch.sin(2 * math.pi * torch.as_tensor(t, **z)
                                       / TIDE_PERIOD)
                  * torch.ones((3, m.nt), **z))
        return stepper.Forcing3D(forcing2d=dg2d.Forcing2D(eta_open=eta_bc),
                                 tau_x=tau_x, tau_y=tau_y,
                                 T_open=T_open, S_open=S_open)
    return geom, vg, cfg, st, forcing_at


def full_size_setup(dtype=torch.float64, device=None):
    """`setup` at FULL_SIZE, with m_2d the larger of FULL_SIZE_M2D_MIN and
    `quickstart.external_substeps` at the deepest point.

    Returns (geom, vg, cfg, st, forcing_at, m_cfl), m_cfl being what
    external_substeps asked for."""
    from .quickstart import external_substeps
    f = FULL_SIZE
    m_cfl = external_substeps(reef_mesh(f["nx"], f["ny"], f["lx"], f["ly"]),
                              f["dt"], depth=f["depth_deep"])
    return (*setup(m_2d=max(FULL_SIZE_M2D_MIN, m_cfl), dtype=dtype,
                   device=device, **f), m_cfl)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--nl", type=int, default=5)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    geom, vg, cfg, st, forcing_at = setup(args.nx, args.nl,
                                          dtype=getattr(torch, args.dtype),
                                          device=args.device)
    sync = (torch.cuda.synchronize if geom.area.device.type == "cuda"
            else (lambda: None))
    print(f"mesh: {geom.nt} triangles x {args.nl} layers on "
          f"{geom.area.device}; reef bathymetry {float(vg.b.min()):.0f}-"
          f"{float(vg.b.max()):.0f} m; tidal+wind forcing; dt={cfg.dt}s, "
          f"m={cfg.m_2d}")
    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
        st = stepper.step(geom, vg, cfg, st, forcing_at(st.time))
        if i % 5 == 0 or i == args.steps - 1:
            v = surface_vorticity(geom, st).abs().cpu().numpy()
            print(f"step {i:3d} t={float(st.time):7.0f}s "
                  f"max|u|={float(st.ux.abs().max()):.4f} m/s "
                  f"|vort| p50={np.percentile(v, 50):.2e} "
                  f"p99={np.percentile(v, 99):.2e} 1/s")
    sync()
    wall = time.perf_counter() - t0
    ratio = args.steps * cfg.dt / wall
    print(f"\n{args.steps} steps in {wall:.1f}s -> physical/wall ratio "
          f"{ratio:.1f} on {geom.area.device} (diagnostics included)")
    if not bool(torch.isfinite(st.ux).all()):
        raise SystemExit("NaN detected")
    print("OK")
    return ratio


if __name__ == "__main__":
    main()
