"""Split-IMEX RK2 time stepper coupling the internal (3D) and external (2D)
modes — the paper's §1.2/§2 scheme (Ishimwe et al. 2023/2025), with the five
components of Figure 2 per stage:

  1. 3D horizontal momentum flux prediction (always explicit) -> F_3D->2D
  2. external mode burst (m sub-steps of SSPRK3)               -> eta, F2D, Qbar
  3. turbulence update (GLS)                                   -> nu_v, kappa_v
  4. momentum update with the 2D correction (vertically implicit on stage 1)
  5. tracer update (same machinery, T & S solved together)

Stage 1 advances t -> t + dt/2 vertically-implicitly; stage 2 re-integrates
t -> t + dt with midpoint fluxes, vertically explicit (paper Fig. 2; for
vertically explicit steps the turbulence update is performed last).

The default is the fused horizontal pipeline (`core/horizontal.py`);
`fused_horizontal=False` runs the per-call path, which recomputes every
interpolation per call at the lateral qps and launches no lateral-flux
kernel (the equivalence oracle of the fused one).  The exchange hooks of
`step` and `stage` are the distributed runtime's (`distributed/ocean.py`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import dg2d, dg3d, eos, horizontal, turbulence, vertical
from . import geometry as G
from ..kernels import ops as kops
from ..obs import trace
from .dg2d import Forcing2D, State2D
from .extrusion import (VGrid, expand2d, layer_geometry, mesh_velocity,
                        node_z, vsum_dofs)

RHO0 = 1025.0


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Static model configuration."""
    nl: int = 8                  # vertical layers
    dt: float = 60.0             # internal (baroclinic) step [s]
    m_2d: int = 20               # external sub-steps per internal step
    coriolis_f: float = 0.0
    cd_bottom: float = 2.5e-3
    cs_smag: float = 0.1
    eos_kind: str = "linear"
    h_min: float = 0.05
    implicit_stage1: bool = True
    exact_consistency: bool = True
    nu_v_bg: float = 1e-4        # background vertical viscosity
    kappa_v_bg: float = 1e-5
    use_gls: bool = True
    halo_exchange_period: int = 0  # 0: per 2D RK stage; j>0: every j substeps
    backend: str = "auto"        # kernel backend (kernels/dispatch.py):
                                 # ref | plain | cuda | auto (auto: cuda on
                                 # CUDA tensors, plain on CPU tensors)
    fused_horizontal: bool = True  # per-stage shared interpolation caches +
                                   # k-stacked momentum/tracer advection
                                   # (core/horizontal.py); False runs the
                                   # per-call path (equivalence oracle)

    def with_recovery(self, dt_factor: float = 0.5,
                      visc_factor: float = 1.0) -> "OceanConfig":
        """Degraded-mode config for a recovery ladder: ``dt`` scales by
        ``dt_factor`` with ``m_2d`` kept, so every CFL number shrinks by the
        same factor; ``visc_factor > 1`` also bumps the background vertical
        mixing."""
        return dataclasses.replace(
            self, dt=self.dt * dt_factor,
            nu_v_bg=self.nu_v_bg * visc_factor,
            kappa_v_bg=self.kappa_v_bg * visc_factor)


@dataclasses.dataclass(frozen=True)
class OceanState:
    ext: State2D                     # 2D external state (eta, Qx, Qy)
    ux: torch.Tensor                 # (nl, 6, nt)
    uy: torch.Tensor
    T: torch.Tensor                  # (nl, 6, nt)
    S: torch.Tensor
    turb_k: torch.Tensor             # (nl, nt)
    turb_eps: torch.Tensor
    nu_t: torch.Tensor               # (nl, nt)
    kappa_t: torch.Tensor
    time: torch.Tensor               # scalar


@dataclasses.dataclass(frozen=True)
class Forcing3D:
    forcing2d: Forcing2D = Forcing2D()
    tau_x: Optional[torch.Tensor] = None    # (3, nt) wind stress / rho0
    tau_y: Optional[torch.Tensor] = None
    T_open: Optional[torch.Tensor] = None   # (nl, 6, nt) open-boundary tracer
    S_open: Optional[torch.Tensor] = None


def init_state(geom: G.Geom2D, vg: VGrid, T0: float = 10.0, S0: float = 35.0,
               dtype=None) -> OceanState:
    """Fluid at rest with uniform T, S, on the geometry's device (and dtype
    unless one is given)."""
    dtype = geom.area.dtype if dtype is None else dtype
    z = dict(dtype=dtype, device=geom.area.device)
    nt, nl = geom.nt, vg.nl
    z2 = torch.zeros((3, nt), **z)
    z3 = torch.zeros((nl, 6, nt), **z)
    ts = turbulence.init_turbulence(nl, nt, **z)
    return OceanState(
        ext=State2D(z2, z2, z2), ux=z3, uy=z3,
        T=torch.full((nl, 6, nt), T0, **z), S=torch.full((nl, 6, nt), S0, **z),
        turb_k=ts.k, turb_eps=ts.eps, nu_t=ts.nu_t, kappa_t=ts.kappa_t,
        time=torch.zeros((), **z))


class StageOut(NamedTuple):
    ext: State2D
    ux: torch.Tensor
    uy: torch.Tensor
    T: torch.Tensor
    S: torch.Tensor
    turb: turbulence.TurbState
    r: torch.Tensor         # internal pressure gradient (diagnostics)
    w_tilde: torch.Tensor   # vertical velocity (diagnostics)


def _momentum_extra(geom, vge, cfg, r, ux_e, uy_e):
    """Coriolis - f ez x u and internal pressure -M r/rho0 (raw assembled)."""
    fx = cfg.coriolis_f * vertical.mass_apply3d(geom, vge.jz, uy_e) \
        - vertical.mass_apply3d(geom, vge.jz, r[0]) / RHO0
    fy = -cfg.coriolis_f * vertical.mass_apply3d(geom, vge.jz, ux_e) \
        - vertical.mass_apply3d(geom, vge.jz, r[1]) / RHO0
    return torch.stack([fx, fy])


def _bottom_drag_coeff(cfg, ux_e, uy_e):
    """Linearised quadratic drag Cd |u_bot| at the floor nodes: (3, nt)."""
    ub = ux_e[-1, 3:6, :]
    vb = uy_e[-1, 3:6, :]
    return cfg.cd_bottom * torch.sqrt(ub ** 2 + vb ** 2 + 1e-12)


def _wind_rhs(geom, tau, like):
    """Surface Neumann wind-stress contribution to the vertical-solve RHS."""
    out = torch.zeros_like(like)
    if tau is not None:
        out[0, 0:3, :] = G.vol_scatter(geom, G.vol_interp(tau))
    return out


def _pressure_dbar(vg: VGrid, vge) -> torch.Tensor:
    """Approximate pressure (dbar ~ m depth) at prism nodes for the EOS."""
    eta6 = torch.cat([vge.eta, vge.eta], dim=-2)
    return torch.clamp(eta6 - node_z(vg, vge), min=0.0)


def stage(geom: G.Geom2D, vg: VGrid, cfg: OceanConfig, st0: OceanState,
          ux_e: torch.Tensor, uy_e: torch.Tensor, T_e: torch.Tensor,
          S_e: torch.Tensor, eta_e: torch.Tensor,
          turb0: turbulence.TurbState, dtau: float, m_sub: int,
          implicit: bool, forcing: Forcing3D,
          turb_base: Optional[turbulence.TurbState] = None,
          exchange2d=None, exchange_field=None) -> StageOut:
    """One IMEX stage: evaluate fluxes at (ux_e, ..., eta_e), advance the
    state *from st0* over dtau with m_sub external sub-steps.

    turb0 provides the mixing coefficients; turb_base (default turb0) is the
    state the turbulence model is advanced *from*."""
    if turb_base is None:
        turb_base = turb0
    if exchange_field is not None:
        # distributed: refresh ghost rings of the evaluation fields (the
        # external state is refreshed inside run_external)
        ux_e = exchange_field(ux_e)
        uy_e = exchange_field(uy_e)
        T_e = exchange_field(T_e)
        S_e = exchange_field(S_e)
        eta_e = exchange_field(eta_e)
    nl = cfg.nl
    vge0 = layer_geometry(vg, st0.ext.eta, cfg.h_min)   # M0 mesh
    vgee = layer_geometry(vg, eta_e, cfg.h_min)         # evaluation mesh

    # --- per-stage shared interpolations (fused horizontal pipeline) --------
    with trace.annotate("stage.edge_cache"):
        hc = (horizontal.stage_cache(geom, vgee, cfg.h_min)
              if cfg.fused_horizontal else None)

    # --- density, pressure gradient r (matrix-free solve) -------------------
    with trace.annotate("stage.pressure_gradient"):
        rho = eos.rho_prime(S_e, T_e, _pressure_dbar(vg, vgee), cfg.eos_kind)
        F_r, r_s = dg3d.pressure_gradient_rhs(geom, vg, vgee, rho, cache=hc)
        r = kops.solve_r(geom, F_r, r_s, backend=cfg.backend)  # (2,nl,6,nt)

    # --- component 1: horizontal flux prediction (with q, not qbar) ---------
    with trace.annotate("stage.flux_prediction"):
        q = dg3d.transport_from_velocity(vgee, ux_e, uy_e)
        if hc is not None:
            tc_pred = horizontal.transport_cache(geom, vgee, vg, hc, q[0],
                                                 q[1], h_min=cfg.h_min)
            flux_pred = tc_pred.flux
        else:
            tc_pred = None
            flux_pred = dg3d.lateral_flux_speed(
                geom, vgee, vg, q[0], q[1], eta_e, vg.b, h_min=cfg.h_min)
        nu_h = dg3d.smagorinsky_nu(geom, ux_e, uy_e, cfg.cs_smag)
        u_pair = torch.stack([ux_e, uy_e])
        if hc is not None:
            # FieldStates of the evaluation velocity + its diffusion term,
            # built ONCE: the prediction and the momentum update share them
            fs_u = dg3d.field_states(geom, u_pair, bc_reflect=True)
            diff_u = dg3d.horizontal_diffusion(geom, vgee, nl, u_pair, nu_h,
                                               hc, fs_u)
            f3h_pred = dg3d.horizontal_advection(
                geom, vgee, nl, u_pair, q[0], q[1], flux_pred, tc_pred, fs_u,
                backend=cfg.backend) + diff_u
        else:
            f3h_pred = dg3d.horizontal_advdiff(
                geom, vgee, nl, u_pair, q[0], q[1], flux_pred, nu_h,
                bc_reflect=True, backend=cfg.backend)
        f3h_pred = f3h_pred + _momentum_extra(geom, vgee, cfg, r, ux_e, uy_e)

        # F_3D->2D: vertical sum + wind + (predicted) bottom drag
        drag = _bottom_drag_coeff(cfg, ux_e, uy_e)
        dq = G.vol_interp(drag)
        ubq = G.vol_interp(ux_e[-1, 3:6, :])
        vbq = G.vol_interp(uy_e[-1, 3:6, :])
        f3d2d_x = vsum_dofs(f3h_pred[0]) - G.vol_scatter(geom, dq * ubq)
        f3d2d_y = vsum_dofs(f3h_pred[1]) - G.vol_scatter(geom, dq * vbq)
        if forcing.tau_x is not None:
            f3d2d_x = f3d2d_x + G.mass_apply(geom, forcing.tau_x)
            f3d2d_y = f3d2d_y + G.mass_apply(geom, forcing.tau_y)

    # --- component 2: external mode burst ------------------------------------
    with trace.annotate("stage.external_burst"):
        ext = dg2d.run_external(geom, vg.b, st0.ext, dtau, m_sub,
                                forcing.forcing2d, f3d2d_x, f3d2d_y,
                                h_min=cfg.h_min, exchange_fn=exchange2d,
                                exchange_period=cfg.halo_exchange_period)
        eta1 = ext.state.eta
        vge1 = layer_geometry(vg, eta1, cfg.h_min)

    # --- component 3: turbulence ---------------------------------------------
    with trace.annotate("stage.turbulence"):
        dz = torch.clamp(vgee.H.mean(dim=0, keepdim=True), min=cfg.h_min) / nl
        if cfg.use_gls and implicit:
            m2, n2 = turbulence.shear_and_buoyancy(ux_e, uy_e, rho, dz)
            turb1 = turbulence.gls_step(turb_base, m2, n2, dz, dtau,
                                        backend=cfg.backend)
        else:
            turb1 = turb0
        turb_used = turb1 if implicit else turb0
        kv = turbulence.to_nodes(turb_used.nu_t) + cfg.nu_v_bg
        kap = turbulence.to_nodes(turb_used.kappa_t) + cfg.kappa_v_bg

    # --- consistent transport, vertical velocity, mesh velocity --------------
    with trace.annotate("stage.w_solve"):
        qbar = dg3d.consistent_transport(vgee, ux_e, uy_e, ext.q_bar_x,
                                         ext.q_bar_y, nl)
        fb_kw = (dict(fbar_edge=ext.fbar_edge,
                      qbar2d=(ext.q_bar_x, ext.q_bar_y))
                 if cfg.exact_consistency else {})
        if hc is not None:
            tc = horizontal.transport_cache(geom, vgee, vg, hc, qbar[0],
                                            qbar[1], h_min=cfg.h_min, **fb_kw)
            flux_c = tc.flux
        else:
            tc = None
            flux_c = dg3d.lateral_flux_speed(
                geom, vgee, vg, qbar[0], qbar[1], eta_e, vg.b,
                h_min=cfg.h_min, **fb_kw)
        w_t = kops.solve_w(
            geom, dg3d.continuity_rhs(geom, vgee, nl, qbar[0], qbar[1],
                                      flux_c, tc),
            backend=cfg.backend)

        wm_i = mesh_velocity(vg, st0.ext.eta, eta1, dtau)    # (nl+1, 3, nt)
        wm_nodes = torch.cat([wm_i[:-1], wm_i[1:]], dim=1)
        wrel = w_t - wm_nodes
        # interface advective speeds: value from BELOW each interface; floor: 0
        wface = torch.cat([w_t[:, 0:3, :] - wm_i[:-1],
                           torch.zeros_like(w_t[:1, 0:3, :])], dim=0)

    # --- components 4+5 horizontal RHS: momentum + tracers ------------------
    with trace.annotate("stage.horizontal_rhs"):
        kap_h = dg3d.okubo_kappa(geom, nl)
        tr_pair = torch.stack([T_e, S_e])
        open_vals = None
        if forcing.T_open is not None:
            open_vals = torch.stack([forcing.T_open, forcing.S_open])
        if hc is not None:
            # momentum + tracers share flux_c; velocity FieldStates and the
            # momentum diffusion are reused from the prediction call
            f3h, f3h_tr = horizontal.advdiff_momentum_tracers(
                geom, vgee, nl, u_pair, tr_pair, qbar[0], qbar[1], flux_c,
                nu_h, kap_h, hc, tc, fs_u=fs_u, diff_u=diff_u,
                open_tr=open_vals, backend=cfg.backend)
        else:
            f3h = dg3d.horizontal_advdiff(
                geom, vgee, nl, u_pair, qbar[0], qbar[1], flux_c, nu_h,
                bc_reflect=True, backend=cfg.backend)
            f3h_tr = dg3d.horizontal_advdiff(
                geom, vgee, nl, tr_pair, qbar[0], qbar[1], flux_c, kap_h,
                open_values=open_vals, backend=cfg.backend)

    # --- component 4: momentum update ----------------------------------------
    with trace.annotate("stage.momentum_update"):
        f3h = f3h + _momentum_extra(geom, vgee, cfg, r, ux_e, uy_e)
        # ONE mass-blocks assembly per stage, shared by the two implicit solves
        M1b = vertical.mass_blocks(geom, vge1.jz, nl) if implicit else None

        H1 = torch.clamp(eta1 + vg.b, min=cfg.h_min)
        f2d_term = torch.stack([
            vertical.mass_apply3d(geom, vge1.jz, expand2d(ext.f2d_x / H1, nl)),
            vertical.mass_apply3d(geom, vge1.jz, expand2d(ext.f2d_y / H1, nl))])
        m0u = torch.stack([vertical.mass_apply3d(geom, vge0.jz, st0.ux),
                           vertical.mass_apply3d(geom, vge0.jz, st0.uy)])
        wind = torch.stack([_wind_rhs(geom, forcing.tau_x, f3h[0]),
                            _wind_rhs(geom, forcing.tau_y, f3h[1])])
        rhs_u = m0u + dtau * (f3h + f2d_term + wind)

        A_u = vertical.assemble_vertical_operator(
            geom, nl, vgee.jz, wrel, wface, kv, vgee.H, drag_coeff=drag)
        if implicit:
            sys = vertical.implicit_system(M1b, A_u, dtau)
            u1 = kops.block_thomas(sys, rhs_u, backend=cfg.backend)
        else:
            f3v = vertical.blocks_matvec(A_u, torch.stack([ux_e, uy_e]))
            u1 = vertical.mass_solve3d(geom, vge1.jz, rhs_u + dtau * f3v)
        del A_u

    # --- component 5: tracers (T & S solved together) -------------------------
    with trace.annotate("stage.tracer_update"):
        m0tr = torch.stack([vertical.mass_apply3d(geom, vge0.jz, st0.T),
                            vertical.mass_apply3d(geom, vge0.jz, st0.S)])
        rhs_tr = m0tr + dtau * f3h_tr
        A_tr = vertical.assemble_vertical_operator(
            geom, nl, vgee.jz, wrel, wface, kap, vgee.H, drag_coeff=None)
        if implicit:
            sysT = vertical.implicit_system(M1b, A_tr, dtau)
            tr1 = kops.block_thomas(sysT, rhs_tr, backend=cfg.backend)
        else:
            f3v_tr = vertical.blocks_matvec(A_tr, tr_pair)
            tr1 = vertical.mass_solve3d(geom, vge1.jz, rhs_tr + dtau * f3v_tr)

    if cfg.use_gls and not implicit:
        # explicit steps update turbulence last (paper Fig. 2a caption),
        # advancing from turb_base (t0) with end-of-step shear/buoyancy
        with trace.annotate("stage.turbulence_final"):
            rho1 = eos.rho_prime(tr1[1], tr1[0], _pressure_dbar(vg, vge1),
                                 cfg.eos_kind)
            m2, n2 = turbulence.shear_and_buoyancy(u1[0], u1[1], rho1, dz)
            turb1 = turbulence.gls_step(turb_base, m2, n2, dz, dtau,
                                        backend=cfg.backend)

    return StageOut(ext=ext.state, ux=u1[0], uy=u1[1], T=tr1[0], S=tr1[1],
                    turb=turb1, r=r, w_tilde=w_t)


def state_to_cell(st: OceanState, backend: Optional[str] = None) -> dict:
    """Cell-layout (nc, nl*6, 128) copies of the 3D prognostic fields through
    the cell-transpose kernel: the step-boundary transform (paper §2.1.2) for
    cell-major storage and I/O.  The step itself runs in the SoA layout."""
    f = lambda x: kops.soa_to_cell(x, backend=backend)
    return {"ux": f(st.ux), "uy": f(st.uy), "T": f(st.T), "S": f(st.S)}


def state_from_cell(st: OceanState, cells: dict, nt: int,
                    backend: Optional[str] = None) -> OceanState:
    """Rebuild the SoA prognostic fields from state_to_cell output."""
    f = lambda x: kops.cell_to_soa(x, nt, backend=backend)
    return dataclasses.replace(st, ux=f(cells["ux"]), uy=f(cells["uy"]),
                               T=f(cells["T"]), S=f(cells["S"]))


def step(geom: G.Geom2D, vg: VGrid, cfg: OceanConfig, st: OceanState,
         forcing: Forcing3D = Forcing3D(),
         exchange2d=None, exchange_field=None) -> OceanState:
    """One full internal step: IMEX midpoint (stage 1 implicit over dt/2,
    stage 2 explicit over dt with midpoint fluxes).  The exchange hooks are
    supplied by the distributed runtime (distributed/ocean.py)."""
    with trace.annotate("ocean.step", profiler=False):
        turb0 = turbulence.TurbState(st.turb_k, st.turb_eps, st.nu_t,
                                     st.kappa_t)
        with trace.annotate("imex.stage1"):
            s1 = stage(geom, vg, cfg, st, st.ux, st.uy, st.T, st.S,
                       st.ext.eta, turb0, cfg.dt / 2, max(cfg.m_2d // 2, 1),
                       cfg.implicit_stage1, forcing,
                       exchange2d=exchange2d, exchange_field=exchange_field)
        with trace.annotate("imex.stage2"):
            s2 = stage(geom, vg, cfg, st, s1.ux, s1.uy, s1.T, s1.S,
                       s1.ext.eta, s1.turb, cfg.dt, cfg.m_2d, False, forcing,
                       turb_base=turb0, exchange2d=exchange2d,
                       exchange_field=exchange_field)
        return OceanState(
            ext=s2.ext, ux=s2.ux, uy=s2.uy, T=s2.T, S=s2.S,
            turb_k=s2.turb.k, turb_eps=s2.turb.eps, nu_t=s2.turb.nu_t,
            kappa_t=s2.turb.kappa_t, time=st.time + cfg.dt)
