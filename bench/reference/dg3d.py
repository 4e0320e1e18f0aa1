"""3D DG operators on the prismatic mesh (paper SI §S2–S3), for the plain
reference: a frozen copy of the port's `core/dg3d.py` on its per-call path
(every interpolation recomputed per call at the lateral qps, no per-stage
caches, no lateral-flux kernel).  Provides:
  * prism quadrature helpers (zeta interpolation, lateral-face scatter),
  * the qp-level exterior states (`reflect_pair`) and the per-field-set
    `FieldStates`,
  * the horizontal advection (lateral term through `lat_scatter`) and
    diffusion terms of F_3D^h / eq. 20 (`horizontal_advdiff`: both),
  * the RHS of the hydrostatic pressure gradient r (SI eq. 11) and of the
    modified continuity equation for w-tilde (SI eq. 13),
  * the consistent 3D transport q-bar (paper eq. 18) and the lateral flux
    speed  n.{q} + {Jz/H} (Fbar_edge - n.{Qbar})  (exact consistency) or
    n.{q} + {Jz/H} c+ [[eta]]  (the paper's literal form),
  * Smagorinsky / Okubo horizontal mixing coefficients.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import geometry as G
from .extrusion import VGrid, VertGeom, interface_z, vsum_dofs
from .vertical import PHI_Z

RHO0 = 1025.0


# ---------------------------------------------------------------------------
# Prism quadrature helpers
# ---------------------------------------------------------------------------
def zinterp(f: torch.Tensor) -> torch.Tensor:
    """Vertical interp of a prism field to the 2 Gauss-zeta levels.

    (..., nl, 6, nt) -> (..., nl, 2qz, 3, nt), nodal in horizontal."""
    ft = f[..., :, 0:3, :]
    fb = f[..., :, 3:6, :]
    return torch.stack([ft * PHI_Z[z, 0] + fb * PHI_Z[z, 1] for z in range(2)],
                       dim=-3)


def _zsplit(s: torch.Tensor) -> torch.Tensor:
    """(..., 2qz, 3, nt) qz-values -> (..., 6, nt) against the top / bottom
    vertical test functions."""
    top = PHI_Z[0, 0] * s[..., 0, :, :] + PHI_Z[1, 0] * s[..., 1, :, :]
    bot = PHI_Z[0, 1] * s[..., 0, :, :] + PHI_Z[1, 1] * s[..., 1, :, :]
    return torch.cat([top, bot], dim=-2)


def vol3d_scatter(geom: G.Geom2D, g: torch.Tensor) -> torch.Tensor:
    """Prism volume integral against all 6 test functions.

    g: (..., nl, 2qz, 3qh, nt) integrand (without Jacobians) -> (..., nl, 6, nt)."""
    return _zsplit(G.vol_scatter(geom, g))


def lat_interp(f: torch.Tensor) -> torch.Tensor:
    """Interior values at lateral-face qps: (..., nl, 6, nt) ->
    (..., nl, 2qz, 3edge, 2qs, nt)."""
    return G.edge_interp(zinterp(f))


def lat_interp_ext(geom: G.Geom2D, f: torch.Tensor) -> torch.Tensor:
    return G.edge_interp_ext(geom, zinterp(f))


def lat_scatter(geom: G.Geom2D, g: torch.Tensor) -> torch.Tensor:
    """Lateral-face integral against all 6 test functions.

    g: (..., nl, 2qz, 3edge, 2qs, nt) integrand -> (..., nl, 6, nt)."""
    return _zsplit(G.edge_scatter(geom, g))


def iso_grad(geom: G.Geom2D, f_qz: torch.Tensor) -> torch.Tensor:
    """Iso-zeta horizontal gradient: (..., nl, 2qz, 3, nt) -> (..., nl, 2qz, 2, nt)."""
    return G.grad2d(geom, f_qz)


# ---------------------------------------------------------------------------
# Boundary ghosts for 3D lateral faces (qp level)
# ---------------------------------------------------------------------------
def reflect_pair(geom: G.Geom2D, uxe: torch.Tensor, uye: torch.Tensor):
    """Free-slip wall reflection of exterior velocity values at lateral qps
    (gathered ext == int on boundaries, so reflecting gives the ghost)."""
    nx = geom.edge_nx[:, None, :]
    ny = geom.edge_ny[:, None, :]
    wall = geom.wall[None, :, None, :]
    un = uxe * nx + uye * ny
    return (uxe - 2 * wall * un * nx, uye - 2 * wall * un * ny)


# ---------------------------------------------------------------------------
# Consistent 3D transport (paper eq. 18 + §2.5)
# ---------------------------------------------------------------------------
def transport_from_velocity(vge: VertGeom, ux: torch.Tensor,
                            uy: torch.Tensor) -> torch.Tensor:
    """q = J_z u projected (nodally) to the linear basis: (2, nl, 6, nt)."""
    jz6 = torch.cat([vge.jz, vge.jz], dim=-2)
    return torch.stack([ux * jz6, uy * jz6])


def consistent_transport(vge: VertGeom, ux, uy, qbar_x2d, qbar_y2d, nl: int):
    """q-bar: nodal J_z u corrected so that the sum over vertical DOFs equals
    the externally-averaged 2D transport Q-bar exactly (paper eq. 18)."""
    q = transport_from_velocity(vge, ux, uy)

    def fix(qc, Q2d):
        d = (Q2d - vsum_dofs(qc)) / (2.0 * nl)
        return qc + torch.cat([d, d], dim=-2)[None]
    return torch.stack([fix(q[0], qbar_x2d), fix(q[1], qbar_y2d)])


# ---------------------------------------------------------------------------
# Lateral advective flux speed (per lateral qp)
# ---------------------------------------------------------------------------
class LateralFlux(NamedTuple):
    speed: torch.Tensor     # (nl, 2qz, 3, 2qs, nt) signed normal flux speed
    upwind: torch.Tensor    # same shape, 1.0 where interior side is upwind


def lateral_flux_speed(geom: G.Geom2D, vge: VertGeom, vg: VGrid,
                       qx: torch.Tensor, qy: torch.Tensor,
                       eta: torch.Tensor, b2d: torch.Tensor,
                       fbar_edge: Optional[torch.Tensor] = None,
                       qbar2d: Optional[tuple] = None,
                       h_min: float = 0.05) -> LateralFlux:
    """Normal advective flux speed at lateral qps.

    paper form:   n.{q} + {Jz/H} c+ [[eta]]          (fbar_edge=None)
    exact form:   n.{q} + {Jz/H} (Fbar - n.{Qbar})   (fbar_edge given)
    Wall faces: reflected ghost -> n.{q} = 0, [[eta]]=0 -> speed 0.
    vg is unused."""
    nx = geom.edge_nx[:, None, :]
    ny = geom.edge_ny[:, None, :]
    qxi, qyi = lat_interp(qx), lat_interp(qy)
    qxe, qye = reflect_pair(geom, lat_interp_ext(geom, qx),
                            lat_interp_ext(geom, qy))
    mean_qn = 0.5 * ((qxi + qxe) * nx + (qyi + qye) * ny)
    a = vge.jz / torch.clamp(vge.H, min=h_min)
    alpha = 0.5 * (G.edge_interp(a) + G.edge_interp_ext(geom, a))
    alpha = alpha[None, None]

    if fbar_edge is not None:
        Qbx, Qby = qbar2d
        Qxi, Qxe = G.edge_interp(Qbx), G.edge_interp_ext(geom, Qbx)
        Qyi, Qye = G.edge_interp(Qby), G.edge_interp_ext(geom, Qby)
        wall2 = geom.wall[:, None, :]
        Qn_e = Qxe * nx + Qye * ny
        Qxe = Qxe - 2 * wall2 * Qn_e * nx
        Qye = Qye - 2 * wall2 * Qn_e * ny
        mean_Qn = 0.5 * ((Qxi + Qxe) * nx + (Qyi + Qye) * ny)
        speed = mean_qn + alpha * (fbar_edge - mean_Qn)[None, None]
    else:
        H2 = torch.clamp(eta + b2d, min=h_min)
        Hi, He = G.edge_interp(H2), G.edge_interp_ext(geom, H2)
        ei, ee = G.edge_interp(eta), G.edge_interp_ext(geom, eta)
        c_plus = torch.sqrt(G.G_GRAV * torch.maximum(Hi, He))
        jump_eta = 0.5 * (ei - ee) * (1.0 - geom.wall[:, None, :])
        speed = mean_qn + alpha * (c_plus * jump_eta)[None, None]
    return LateralFlux(speed=speed, upwind=(speed > 0).to(speed.dtype))


# ---------------------------------------------------------------------------
# Horizontal advection-diffusion (momentum & tracers share this)
# ---------------------------------------------------------------------------
class FieldStates(NamedTuple):
    """Field-dependent interpolations of one advected field set."""
    fq: torch.Tensor        # (k, nl, 2qz, 3, nt)      zeta-interp
    fqq: torch.Tensor       # (k, nl, 2qz, 3qh, nt)    vol-quad values
    fi: torch.Tensor        # (k, nl, 2qz, 3, 2qs, nt) interior lateral states
    fe: torch.Tensor        # same, exterior (post-BC)
    gradf: torch.Tensor     # (k, nl, 2qz, 2, nt)      iso-zeta gradient
    gno: torch.Tensor       # (k, nl, 2qz, 3e, nt)     interior normal gradient
    gradf_e: torch.Tensor   # same, exterior


def field_states(geom: G.Geom2D, f: torch.Tensor, bc_reflect: bool = False,
                 open_values: Optional[torch.Tensor] = None) -> FieldStates:
    """Build the FieldStates of (k, nl, 6, nt) fields, the exterior states
    at the lateral qps.

    bc_reflect: the first two components are the horizontal velocity vector
    (free-slip wall reflection of the exterior states)."""
    k = f.shape[0]
    if bc_reflect and k < 2:
        raise ValueError("bc_reflect needs the two velocity components")
    fq = zinterp(f)
    fqq = G.vol_interp(fq)
    fi = lat_interp(f)
    fe = lat_interp_ext(geom, f)
    if bc_reflect:
        fe = torch.cat([torch.stack(reflect_pair(geom, fe[0], fe[1])),
                        fe[2:]])
    if open_values is not None:
        openb = geom.openb[None, :, None, :]
        fe = fe * (1 - openb) + lat_interp(open_values) * openb
    gradf = iso_grad(geom, fq)
    gno = (gradf[..., 0:1, :] * geom.edge_nx
           + gradf[..., 1:2, :] * geom.edge_ny)       # (k, nl, 2qz, 3e, nt)
    gradf_e = _gather_ext_grad(geom, gradf)
    return FieldStates(fq=fq, fqq=fqq, fi=fi, fe=fe,
                       gradf=gradf, gno=gno, gradf_e=gradf_e)


def _vol_transport(qx: torch.Tensor, qy: torch.Tensor):
    """The transport at the volume qps, (nl, 2qz, 3qh, nt) each."""
    return G.vol_interp(zinterp(qx)), G.vol_interp(zinterp(qy))


def horizontal_advdiff(geom: G.Geom2D, vge: VertGeom, nl: int,
                       f: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                       flux: LateralFlux, nu_h: torch.Tensor,
                       bc_reflect: bool = False,
                       open_values: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Horizontal advection + along-sigma diffusion terms of F_3D^h / eq. 20:
    (k, nl, 6, nt) RHS contributions (not mass-inverted), everything
    recomputed per call at the lateral qps."""
    fcache = field_states(geom, f, bc_reflect=bc_reflect,
                          open_values=open_values)
    adv = horizontal_advection(geom, vge, nl, f, qx, qy, flux, fcache)
    return adv + horizontal_diffusion(geom, vge, nl, f, nu_h, fcache)


def horizontal_advection(geom: G.Geom2D, vge: VertGeom, nl: int,
                         f: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                         flux: LateralFlux,
                         fcache: FieldStates) -> torch.Tensor:
    """Flux-dependent half of the horizontal RHS: volume advection +
    lateral upwind flux, (k, nl, 6, nt); the lateral term scatters the
    qp-level upwind states (`lat_scatter`)."""
    qxq, qyq = _vol_transport(qx, qy)
    # --- volume advection: <Jh f (q . phi_z grad(phi_h))> -------------------
    gx = (fcache.fqq * qxq).sum(dim=-2)                # (k, nl, 2qz, nt)
    gy = (fcache.fqq * qyq).sum(dim=-2)
    sx = gx[..., None, :] * geom.dphi[:, 0, :]         # (k, nl, 2qz, 3n, nt)
    sy = gy[..., None, :] * geom.dphi[:, 1, :]
    out = _zsplit((sx + sy) * (geom.area / 3.0))       # (k, nl, 6, nt)

    # --- lateral upwind advective flux --------------------------------------
    f_up = torch.where(flux.upwind > 0.5, fcache.fi, fcache.fe)
    lat_adv = lat_scatter(geom, f_up * flux.speed[None])
    return out - lat_adv


def horizontal_diffusion(geom: G.Geom2D, vge: VertGeom, nl: int,
                         f: torch.Tensor, nu_h: torch.Tensor,
                         fcache: FieldStates) -> torch.Tensor:
    """Along-sigma diffusion half of the horizontal RHS (SIP form); the jz
    interpolations and the penalty coefficient are computed here."""
    jz_q = G.vol_interp(vge.jz)
    jz_int = G.edge_interp(vge.jz)                     # (3, 2qs, nt)
    jz_ext = G.edge_interp_ext(geom, vge.jz)
    sig, jz_mean = sigma3_lateral(geom), 0.5 * (jz_int + jz_ext)
    # volume: -<Jh Jz nu (grad~ phi_i . grad~ f) phi_z^a>
    nu_q = G.vol_interp(zinterp(nu_h))                 # (nl, 2qz, 3qh, nt)
    gradf = fcache.gradf                               # (k, nl, 2qz, 2, nt)
    coef = (nu_q * jz_q).sum(dim=-2) / 3.0 * geom.area  # (nl, 2qz, nt)
    nu_int = lat_interp(nu_h)[None]                    # (1, nl, 2qz, 3, 2qs, nt)
    nu_ext = lat_interp_ext(geom, nu_h)[None]
    dvol = (gradf[..., 0:1, :] * geom.dphi[:, 0, :]
            + gradf[..., 1:2, :] * geom.dphi[:, 1, :]) * coef[..., None, :]
    out = -_zsplit(dvol)

    # lateral consistency: + <<phi {Jz nu n.grad~ f} Jl>> (interior faces)
    flux_int = fcache.gno[..., None, :] * nu_int * jz_int
    flux_ext = fcache.gradf_e[..., None, :] * nu_ext * jz_ext
    interior = geom.interior[None, :, None, :]
    mean_flux = 0.5 * (flux_int + flux_ext)

    # lateral penalty: - <<sigma3 {nu} {Jz} [[f]] Jl>>  (interior faces),
    # assembled with the consistency term in ONE edge scatter
    numean = 0.5 * (nu_int + nu_ext)
    jumpf = 0.5 * (fcache.fi - fcache.fe)
    pen = sig[:, None, :] * numean * jz_mean * jumpf
    return out + lat_scatter(geom, (mean_flux - pen) * interior)


def _gather_ext_grad(geom: G.Geom2D, gradf: torch.Tensor) -> torch.Tensor:
    """Exterior iso-zeta gradient dotted with our outward normal, per edge.

    gradf: (k, nl, 2qz, 2comp, nt) -> (k, nl, 2qz, 3edge, nt)."""
    ge_x = gradf[..., 0, :][..., geom.ext_tri]
    ge_y = gradf[..., 1, :][..., geom.ext_tri]
    return ge_x * geom.edge_nx + ge_y * geom.edge_ny


def sigma3_lateral(geom: G.Geom2D, N0: float = 5.0, o: int = 1,
                   d: int = 3) -> torch.Tensor:
    """Interior-penalty coefficient on lateral faces (eq. 19): L = A/l."""
    L_int = geom.area[None, :] / geom.edge_len
    L_ext = geom.area[geom.ext_tri] / geom.edge_len
    return N0 * (o + 1) * (o + d) / (2.0 * d * torch.minimum(L_int, L_ext))


# ---------------------------------------------------------------------------
# Horizontal mixing coefficients (paper §1.1: Smagorinsky / Okubo)
# ---------------------------------------------------------------------------
def smagorinsky_nu(geom: G.Geom2D, ux: torch.Tensor, uy: torch.Tensor,
                   cs: float = 0.1, nu_min: float = 1e-3,
                   nu_max: float = 1e4) -> torch.Tensor:
    """Smagorinsky horizontal viscosity: nu = (cs)^2 * 2A * |S|, from the
    layer-mean iso-sigma velocity gradients.  Returns (nl, 6, nt)."""
    um = 0.5 * (ux[:, 0:3, :] + ux[:, 3:6, :])
    vm = 0.5 * (uy[:, 0:3, :] + uy[:, 3:6, :])
    gu = G.grad2d(geom, um)                              # (nl, 2, nt)
    gv = G.grad2d(geom, vm)
    s11, s22 = gu[:, 0], gv[:, 1]
    s12 = 0.5 * (gu[:, 1] + gv[:, 0])
    smag = torch.sqrt(2.0 * (s11 ** 2 + s22 ** 2 + 2.0 * s12 ** 2))
    nu = torch.clamp(cs ** 2 * (2.0 * geom.area) * smag, nu_min, nu_max)
    return nu[:, None, :].expand(nu.shape[0], 6, nu.shape[1])


def okubo_kappa(geom: G.Geom2D, nl: int, coef: float = 2.055e-4,
                expo: float = 1.15) -> torch.Tensor:
    """Okubo (1971) scale-dependent horizontal diffusivity:
    kappa = coef * L^expo with L = sqrt(2A) [m]. Returns (nl, 6, nt)."""
    kap = coef * torch.sqrt(2.0 * geom.area) ** expo
    return kap[None, None, :].expand(nl, 6, kap.shape[0])


# ---------------------------------------------------------------------------
# Pressure gradient RHS (SI eq. 11) + surface value
# ---------------------------------------------------------------------------
def pressure_gradient_rhs(geom: G.Geom2D, vg: VGrid, vge: VertGeom,
                          rho_p: torch.Tensor) -> tuple:
    """RHS of D_vu r = F and the surface Dirichlet value r_s.

    rho_p: (nl, 6, nt) density anomaly. Returns (F (2, nl, 6, nt), r_s (2,3,nt))."""
    g = G.G_GRAV
    nl = vg.nl
    jz_q = G.vol_interp(vge.jz)
    jz_mean = 0.5 * (G.edge_interp(vge.jz) + G.edge_interp_ext(geom, vge.jz))
    # volume: +g <phi grad~_h rho' Jh Jz>
    grho = iso_grad(geom, zinterp(rho_p))               # (nl, 2qz, 2, nt)
    intg = g * grho.movedim(2, 0)[..., None, :] * jz_q  # (2,nl,2qz,3qh,nt)
    F = vol3d_scatter(geom, intg)                       # (2, nl, 6, nt)

    # interior horizontal interfaces k=1..nl-1:
    # -g <<2 phi n_h [[rho']] |Jh/n_z|>>_top ; n_h|Jh/nz| = -grad(z_k) Jh
    gz = G.grad2d(geom, interface_z(vg, vge))           # (nl+1, 2, nt)
    jump = 0.5 * (rho_p[1:, 0:3, :] - rho_p[:-1, 3:6, :])   # (nl-1, 3, nt)
    jq = G.vol_interp(jump)                             # (nl-1, 3qh, nt)
    # sum_qh (A/3) phi_i * (-2 g [[rho']]) * (-grad z_k), on the top face of
    # layer k (k=1..nl-1)
    term = G.vol_scatter(geom, jq[None] * -gz[1:nl].movedim(1, 0)[:, :, None, :])
    F[:, 1:, 0:3, :] += term * (-2.0 * g)

    # lateral: -g <<phi n [[rho']] {Jz} Jl>>
    jumpl = (0.5 * (lat_interp(rho_p) - lat_interp_ext(geom, rho_p))
             * geom.interior[None, :, None, :])
    n_ = torch.stack([geom.edge_nx, geom.edge_ny])      # (2, 3, nt)
    intg_l = (-g) * jumpl[None] * jz_mean * n_[:, None, None, :, None, :]
    F = F + lat_scatter(geom, intg_l)

    # surface value: r_s = g rho'(eta) grad_h(eta)
    geta = G.grad2d(geom, vge.eta)                      # (2, nt)
    r_s = g * rho_p[0, 0:3, :][None] * geta[:, None, :]
    # r grows with depth for a positive density gradient: the top-down solve
    # decreases r by Mh^{-1}F per face, so the RHS is -F
    return -F, r_s


# ---------------------------------------------------------------------------
# Modified continuity RHS for w-tilde (SI eq. 13)
# ---------------------------------------------------------------------------
def continuity_rhs(geom: G.Geom2D, vge: VertGeom, nl: int,
                   qx: torch.Tensor, qy: torch.Tensor,
                   flux: LateralFlux) -> torch.Tensor:
    """RHS of D_vd w~ = F: volume transport divergence + lateral fluxes,
    with the SAME LateralFlux as the tracer/momentum advection so the
    discrete budgets telescope exactly."""
    qxq, qyq = _vol_transport(qx, qy)
    # dphi is constant per triangle, so the qh sum factorises
    sx = qxq.sum(dim=-2)[..., None, :] * geom.dphi[:, 0, :]
    sy = qyq.sum(dim=-2)[..., None, :] * geom.dphi[:, 1, :]
    F = _zsplit((sx + sy) * (geom.area / 3.0))        # (nl, 6, nt)
    return F - lat_scatter(geom, flux.speed)
