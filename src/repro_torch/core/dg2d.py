"""2D barotropic ("external") mode: free surface + depth-averaged momentum.

Discretisation follows the paper's SI §S1:
  * eq (2):  M d(eta)/dt = <Jh grad(phi).Q> - <<phi (n.{Q} + c+ [[eta]]) Jl>> + <phi s Jh>
  * eq (4):  M dQ/dt = -<g phi H grad(eta) Jh> + <<n phi g {H} [[eta]] Jl>>
                        - <<phi c+ [[Q]] Jl>> - <phi (H/rho0) grad(p_atm) Jh>
                        + F_3D->2D
  with the well-balanced form [[H^2/2]] = {H}[[eta]] and a local
  Lax-Friedrichs dissipation speed c+ = max(c_int, c_ext), c = sqrt(gH).

Boundary conditions (via ghost states on the edge quadrature points):
  WALL: eta_ext = eta_int, Q_ext = Q_int - 2 (Q.n) n   (weak impermeability)
  OPEN: eta_ext = eta_bc(t), Q_ext = Q_int             (radiative forcing)

`run_external` advances m sub-steps of SSPRK(3,3) in a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import geometry as G

RHO0 = 1025.0


@dataclasses.dataclass(frozen=True)
class State2D:
    eta: torch.Tensor  # (3, nt)
    qx: torch.Tensor   # (3, nt)
    qy: torch.Tensor   # (3, nt)

    def __add__(self, o):
        return State2D(self.eta + o.eta, self.qx + o.qx, self.qy + o.qy)

    def __mul__(self, a):
        return State2D(self.eta * a, self.qx * a, self.qy * a)

    __rmul__ = __mul__


@dataclasses.dataclass(frozen=True)
class Forcing2D:
    """External-mode forcing, all optional (None disables the term)."""
    eta_open: Optional[torch.Tensor] = None   # (3, nt) open-boundary elevation
    patm: Optional[torch.Tensor] = None       # (3, nt) atmospheric pressure
    tau_x: Optional[torch.Tensor] = None      # (3, nt) wind stress / rho0
    tau_y: Optional[torch.Tensor] = None
    source: Optional[torch.Tensor] = None     # (3, nt) rain/evaporation s


def _edge_states(geom: G.Geom2D, st: State2D, forcing: Forcing2D):
    """Interior/exterior values of (eta, qx, qy) at the edge Gauss points,
    with WALL / OPEN ghost states applied."""
    ei = G.edge_interp(st.eta)
    qxi = G.edge_interp(st.qx)
    qyi = G.edge_interp(st.qy)
    ee = G.edge_interp_ext(geom, st.eta)
    qxe = G.edge_interp_ext(geom, st.qx)
    qye = G.edge_interp_ext(geom, st.qy)

    nx = geom.edge_nx[:, None, :]
    ny = geom.edge_ny[:, None, :]
    wall = geom.wall[:, None, :]
    openb = geom.openb[:, None, :]
    intm = 1.0 - wall - openb

    # WALL ghost: reflect normal transport (gathered ext == int on boundaries)
    qn = qxe * nx + qye * ny
    qx_wall = qxe - 2.0 * qn * nx
    qy_wall = qye - 2.0 * qn * ny
    eta_open = (G.edge_interp(forcing.eta_open)
                if forcing.eta_open is not None else ee)
    eta_e = intm * ee + wall * ei + openb * eta_open
    qx_e = intm * qxe + wall * qx_wall + openb * qxi
    qy_e = intm * qye + wall * qy_wall + openb * qyi
    return (ei, qxi, qyi), (eta_e, qx_e, qy_e)


def external_rhs(geom: G.Geom2D, b: torch.Tensor, st: State2D,
                 forcing: Forcing2D = Forcing2D(),
                 f3d2d_x: Optional[torch.Tensor] = None,
                 f3d2d_y: Optional[torch.Tensor] = None,
                 h_min: float = 0.05,
                 return_flux: bool = False):
    """Right-hand side d/dt (eta, Q) — already multiplied by M^{-1}.

    With return_flux=True also returns the free-surface edge flux
    (n.{Q} + c+[[eta]]) at the edge Gauss points, (3, 2, nt)."""
    g = G.G_GRAV
    H = torch.clamp(st.eta + b, min=h_min)

    (ei, qxi, qyi), (ee, qxe, qye) = _edge_states(geom, st, forcing)
    b_e = G.edge_interp(b)
    Hi = torch.clamp(ei + b_e, min=h_min)
    He = torch.clamp(ee + b_e, min=h_min)  # ghost uses own b
    nx = geom.edge_nx[:, None, :]
    ny = geom.edge_ny[:, None, :]

    c_plus = torch.sqrt(g * torch.maximum(Hi, He))
    jump_eta = 0.5 * (ei - ee)
    jump_qx = 0.5 * (qxi - qxe)
    jump_qy = 0.5 * (qyi - qye)
    mean_qn = 0.5 * ((qxi + qxe) * nx + (qyi + qye) * ny)
    mean_H = 0.5 * (Hi + He)

    # ----- free surface -----------------------------------------------------
    qx_q = G.vol_interp(st.qx)
    qy_q = G.vol_interp(st.qy)
    vol_eta = (geom.area / 3.0) * (
        geom.dphi[:, 0, :] * qx_q.sum(dim=0)
        + geom.dphi[:, 1, :] * qy_q.sum(dim=0))
    eta_edge_flux = mean_qn + c_plus * jump_eta
    rhs_eta = vol_eta - G.edge_scatter(geom, eta_edge_flux)
    if forcing.source is not None:
        rhs_eta = rhs_eta + G.mass_apply(geom, forcing.source)

    # ----- momentum -----------------------------------------------------------
    deta = G.grad2d(geom, st.eta)                  # (2, nt)
    H_q = G.vol_interp(H)
    vol_qx = -g * G.vol_scatter(geom, H_q * deta[0][None, :])
    vol_qy = -g * G.vol_scatter(geom, H_q * deta[1][None, :])
    edge_qx = G.edge_scatter(geom, nx * g * mean_H * jump_eta - c_plus * jump_qx)
    edge_qy = G.edge_scatter(geom, ny * g * mean_H * jump_eta - c_plus * jump_qy)
    rhs_qx = vol_qx + edge_qx
    rhs_qy = vol_qy + edge_qy

    if forcing.patm is not None:
        dp = G.grad2d(geom, forcing.patm)
        rhs_qx = rhs_qx - G.vol_scatter(geom, H_q * dp[0][None, :] / RHO0)
        rhs_qy = rhs_qy - G.vol_scatter(geom, H_q * dp[1][None, :] / RHO0)
    if forcing.tau_x is not None:
        rhs_qx = rhs_qx + G.mass_apply(geom, forcing.tau_x)
        rhs_qy = rhs_qy + G.mass_apply(geom, forcing.tau_y)
    if f3d2d_x is not None:
        rhs_qx = rhs_qx + f3d2d_x
        rhs_qy = rhs_qy + f3d2d_y

    out = State2D(G.minv_apply(geom, rhs_eta),
                  G.minv_apply(geom, rhs_qx),
                  G.minv_apply(geom, rhs_qy))
    if return_flux:
        return out, eta_edge_flux
    return out


def standalone_extra_rhs(geom: G.Geom2D, b: torch.Tensor, st: State2D,
                         coriolis_f: float = 0.0,
                         bottom_cd: float = 0.0,
                         h_min: float = 0.05) -> State2D:
    """Optional standalone-2D terms the coupled model gets from S3 instead:
    Coriolis -f ez x Q and quadratic bottom drag -Cd |Q| Q / H^2."""
    H = torch.clamp(st.eta + b, min=h_min)
    rqx = coriolis_f * st.qy
    rqy = -coriolis_f * st.qx
    if bottom_cd > 0:
        qn = torch.sqrt(st.qx ** 2 + st.qy ** 2)
        rqx = rqx - bottom_cd * qn * st.qx / H ** 2
        rqy = rqy - bottom_cd * qn * st.qy / H ** 2
    return State2D(torch.zeros_like(st.eta), rqx, rqy)


def ssprk3_step(rhs_fn: Callable[[State2D], State2D], st: State2D,
                dt: float) -> State2D:
    """Shu-Osher SSPRK(3,3) — the paper's 3-stage explicit RK external mode."""
    k1 = st + dt * rhs_fn(st)
    k2 = 0.75 * st + 0.25 * (k1 + dt * rhs_fn(k1))
    return (1.0 / 3.0) * st + (2.0 / 3.0) * (k2 + dt * rhs_fn(k2))


class ExternalResult(NamedTuple):
    state: State2D
    q_bar_x: torch.Tensor    # (3, nt) effective time-averaged transport
    q_bar_y: torch.Tensor
    f2d_x: torch.Tensor      # (3, nt) momentum input from the external mode
    f2d_y: torch.Tensor
    fbar_edge: torch.Tensor  # (3, 2, nt) effective time-averaged eta edge flux


# SSPRK(3,3) effective stage weights: u1 = u0 + h(F0/6 + F1/6 + 2 F2/3)
_SSP_W = (1.0 / 6.0, 1.0 / 6.0, 2.0 / 3.0)


def run_external(geom: G.Geom2D, b: torch.Tensor, st0: State2D, dt: float,
                 m: int, forcing: Forcing2D = Forcing2D(),
                 f3d2d_x: Optional[torch.Tensor] = None,
                 f3d2d_y: Optional[torch.Tensor] = None,
                 coriolis_f: float = 0.0, bottom_cd: float = 0.0,
                 h_min: float = 0.05,
                 exchange_fn: Optional[Callable[[State2D], State2D]] = None,
                 exchange_period: int = 0) -> ExternalResult:
    """Advance the external mode by m sub-steps of dt/m.

    Returns the new state, the momentum increment F2D (paper eq. 6)
        F2D = (Q1 - (Q0 + dt*F3D2D)) / dt,
    and the stage-weighted time averages of the transport Qbar and of the
    free-surface edge flux Fbar_edge (the eta update is exactly
    dt * div-flux(Qbar, Fbar_edge), which makes the 3D advection discretely
    consistent to machine precision).

    Distributed runs pass `exchange_fn` (halo refresh of the 2D state):
      exchange_period = 0: exchange before every RK-stage RHS (paper §3.3:
        one halo exchange per 2D kernel iteration; needs a 1-deep halo);
      exchange_period = j>0: exchange once per j sub-steps (communication-
        avoiding; needs a 3j-deep halo).  The averages are then taken over
        each group of j sub-steps first and over the m/j group means after,
        the JAX package's order of summation.
    """
    if f3d2d_x is None:
        f3d2d_x = torch.zeros_like(st0.qx)
        f3d2d_y = torch.zeros_like(st0.qy)
    dts = dt / m
    per_stage = exchange_fn is not None and exchange_period == 0

    def rhs(s):
        if per_stage:
            s = exchange_fn(s)
        r, eflux = external_rhs(geom, b, s, forcing, f3d2d_x, f3d2d_y, h_min,
                                return_flux=True)
        if coriolis_f != 0.0 or bottom_cd > 0.0:
            r = r + standalone_extra_rhs(geom, b, s, coriolis_f, bottom_cd,
                                         h_min)
        return r, eflux

    w0, w1, w2 = _SSP_W

    def substep(s):
        r0, ef0 = rhs(s)
        s1 = s + dts * r0
        r1, ef1 = rhs(s1)
        s2 = 0.75 * s + 0.25 * (s1 + dts * r1)
        r2, ef2 = rhs(s2)
        s3 = (1.0 / 3.0) * s + (2.0 / 3.0) * (s2 + dts * r2)
        return s3, (w0 * s.qx + w1 * s1.qx + w2 * s2.qx,
                    w0 * s.qy + w1 * s1.qy + w2 * s2.qy,
                    w0 * ef0 + w1 * ef1 + w2 * ef2)

    s = st0
    accs = []
    if exchange_fn is not None and exchange_period > 0:
        if m % exchange_period:
            raise ValueError(f"{m} sub-steps are not a multiple of the "
                             f"exchange period {exchange_period}")
        for _ in range(m // exchange_period):
            s = exchange_fn(s)
            group = []
            for _ in range(exchange_period):
                s, acc = substep(s)
                group.append(acc)
            accs.append(tuple(sum(a[i] for a in group) / exchange_period
                              for i in range(3)))
    else:
        for _ in range(m):
            s, acc = substep(s)
            accs.append(acc)
    qxs, qys, efs = zip(*accs)
    # paper eq. 6: F2D = (Q1 - (Q0 + dt*F3D2D))/dt with the mass-inverted
    # (nodal-rate) F3D2D
    f2d_x = (s.qx - st0.qx) / dt - G.minv_apply(geom, f3d2d_x)
    f2d_y = (s.qy - st0.qy) / dt - G.minv_apply(geom, f3d2d_y)
    mean = lambda xs: torch.stack(xs).mean(dim=0)
    return ExternalResult(s, mean(qxs), mean(qys), f2d_x, f2d_y, mean(efs))


def cfl_dt(geom: G.Geom2D, b: torch.Tensor, cfl: float = 0.25) -> float:
    """Explicit gravity-wave CFL time step estimate (static, numpy-side):
    h = sqrt(area), with the deepest node of each triangle."""
    h = np.sqrt(geom.area.detach().cpu().numpy())
    c = np.sqrt(G.G_GRAV * np.maximum(b.detach().cpu().numpy().max(axis=0),
                                      0.05))
    return float((cfl * h / c).min())
