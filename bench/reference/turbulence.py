"""GLS two-equation turbulence closure (Umlauf & Burchard 2003), k-epsilon
flavour (a frozen copy of the port's `core/turbulence.py` for the plain
reference), discretised per the paper (§2.4): one degree of freedom per prism
(P0 in the vertical), implicit vertical diffusion -> tridiagonal systems per
column solved by the Thomas algorithm (columns along the last axis).

Simplifications vs the full GLS family:
  * k-epsilon parameter set (p=3, m=1.5, n=-1) only,
  * quasi-equilibrium stability functions reduced to constant c_mu with the
    Galperin stable-stratification length-scale limiter,
  * Patankar-type semi-implicit sources (linearised decay), which keeps k,
    eps positive without clipping artefacts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

G_GRAV = 9.81


@dataclasses.dataclass(frozen=True)
class GLSParams:
    c_mu0: float = 0.5477
    c1: float = 1.44
    c2: float = 1.92
    c3_plus: float = 1.0           # unstable stratification
    c3_minus: float = -0.52        # stable stratification
    sigma_k: float = 1.0
    sigma_e: float = 1.3
    k_min: float = 1e-6
    eps_min: float = 1e-10
    nu_min: float = 1e-6
    nu_max: float = 1.0
    galperin: float = 0.56


class TurbState(NamedTuple):
    k: torch.Tensor        # (nl, nt) TKE per prism
    eps: torch.Tensor      # (nl, nt) dissipation per prism
    nu_t: torch.Tensor     # (nl, nt) eddy viscosity
    kappa_t: torch.Tensor  # (nl, nt) eddy diffusivity


def init_turbulence(nl: int, nt: int, dtype=torch.float64,
                    device=None) -> TurbState:
    z = dict(dtype=dtype, device=device)
    nu = torch.full((nl, nt), 1e-4, **z)
    return TurbState(k=torch.full((nl, nt), 1e-4, **z),
                     eps=torch.full((nl, nt), 1e-8, **z), nu_t=nu, kappa_t=nu)


def thomas_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Tridiagonal solve, layer axis first: all (nl, nt); a Python loop over
    the layers.  dl[0] and du[nl-1] are ignored."""
    nl = d.shape[0]
    cp = torch.zeros_like(d[0])
    dp = torch.zeros_like(d[0])
    cps, dps = [], []
    for l in range(nl):
        denom = d[l] - dl[l] * cp
        cp = du[l] / denom
        dp = (b[l] - dl[l] * dp) / denom
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(d[0])
    xs = [None] * nl
    for l in range(nl - 1, -1, -1):
        x = dps[l] - cps[l] * x
        xs[l] = x
    return torch.stack(xs)


def shear_and_buoyancy(ux: torch.Tensor, uy: torch.Tensor, rho_p: torch.Tensor,
                       dz: torch.Tensor):
    """M2 (shear^2) and N2 (buoyancy frequency^2) at element centres, from
    the element-mean top/bottom face values of (nl, 6, nt) DG fields."""
    def ddz(f):
        ft = f[:, 0:3, :].mean(dim=1)
        fb = f[:, 3:6, :].mean(dim=1)
        return (ft - fb) / dz
    m2 = ddz(ux) ** 2 + ddz(uy) ** 2
    n2 = -(G_GRAV / 1025.0) * ddz(-rho_p)  # z up: N2 = -g/rho0 drho/dz
    return m2, n2


def diffusion_system(nu_t: torch.Tensor, dz: torch.Tensor, dt: float,
                     sigma: float):
    """The implicit vertical diffusion system (1 - dt d/dz nu/sigma d/dz) of
    one GLS variable: (lo, d, up), each (nl, nt), for `thomas_solve`."""
    nl, nt = nu_t.shape
    nu_i = 0.5 * (nu_t[:-1] + nu_t[1:]) / sigma             # interfaces
    dzc = dz.expand(nl, nt)
    dzi = 0.5 * (dzc[:-1] + dzc[1:])
    w = nu_i / dzi                                          # (nl-1, nt)
    zero = torch.zeros((1, nt), dtype=nu_t.dtype, device=nu_t.device)
    lo = torch.cat([zero, -dt * w]) / dzc
    up = torch.cat([-dt * w, zero]) / dzc
    return lo, 1.0 - lo - up, up


def gls_step(ts: TurbState, m2: torch.Tensor, n2: torch.Tensor,
             dz: torch.Tensor, dt: float, params: GLSParams = GLSParams(),
             surf_k: float = 0.0) -> TurbState:
    """Advance k-eps one step: semi-implicit sources + implicit vertical
    diffusion (tridiagonal per column, `thomas_solve`)."""
    p = params
    k0 = torch.clamp(ts.k, min=p.k_min)
    e0 = torch.clamp(ts.eps, min=p.eps_min)

    prod = ts.nu_t * m2
    buoy = -ts.kappa_t * n2
    c3 = torch.where(n2 > 0, torch.full_like(n2, p.c3_minus), p.c3_plus)

    # --- semi-implicit source update (Patankar) ----------------------------
    k_src = (k0 + dt * (prod + torch.clamp(buoy, min=0.0))) / (
        1.0 + dt * (e0 + torch.clamp(-buoy, min=0.0)) / k0)
    e_src = (e0 + dt * (e0 / k0) * (p.c1 * prod
                                    + torch.clamp(c3 * buoy, min=0.0))) / (
        1.0 + dt * p.c2 * e0 / k0 + dt * torch.clamp(-c3 * buoy, min=0.0) / k0)

    # --- implicit vertical diffusion (tridiagonal per column) ---------------
    def diffuse(f, sigma):
        lo, d, up = diffusion_system(ts.nu_t, dz, dt, sigma)
        return thomas_solve(lo, d, up, f)

    k1 = torch.clamp(diffuse(k_src, p.sigma_k), min=p.k_min)
    e1 = torch.clamp(diffuse(e_src, p.sigma_e), min=p.eps_min)

    # Galperin limiter under stable stratification: l <= sqrt(0.56 k / N2)
    e_lim = (p.c_mu0 ** 3) * k1 * torch.sqrt(torch.clamp(n2, min=0.0)
                                             / p.galperin)
    e1 = torch.maximum(e1, e_lim)

    cm = p.c_mu0 ** 4  # ~0.09 for c_mu0 = 0.5477 (standard k-eps c_mu)
    nu_t = torch.clamp(cm * k1 ** 2 / e1, p.nu_min, p.nu_max)
    kap_t = torch.clamp(cm / 1.3 * k1 ** 2 / e1, p.nu_min, p.nu_max)
    return TurbState(k=k1, eps=e1, nu_t=nu_t, kappa_t=kap_t)


def to_nodes(f_p0: torch.Tensor) -> torch.Tensor:
    """Broadcast P0-per-prism coefficients (nl, nt) to DG nodes (nl, 6, nt)."""
    return f_p0[:, None, :].expand(f_p0.shape[0], 6, f_p0.shape[1])
