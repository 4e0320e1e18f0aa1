"""Fused horizontal-RHS pipeline: per-stage interpolation caches.

Each IMEX stage evaluates the horizontal DG terms several times — momentum
flux prediction, momentum update, tracers, two lateral flux speeds, the
continuity RHS and the pressure gradient.  The field-independent and
per-transport interpolations are built once and shared:

  * ``EdgeCache``      — built ONCE per stage from the evaluation-mesh
                         vertical geometry: every field-independent edge /
                         volume interpolation (jz gathers, {Jz/H}, eta/H
                         edge states, sigma3 penalty).
  * ``TransportCache`` — built once per transport (q for the prediction,
                         q-bar for the corrected update): vol-quad transport
                         `qxq/qyq` shared by the advection and
                         `continuity_rhs`, plus the LateralFlux speeds.

`advdiff_momentum_tracers` batches momentum and tracers into a single
k=4-stacked advection call on the kernel backends (their flux speeds
coincide).
"""
from __future__ import annotations

import dataclasses

import torch

from . import dg3d
from . import geometry as G
from .extrusion import VertGeom
from ..kernels import dispatch


@dataclasses.dataclass(frozen=True)
class EdgeCache:
    """Field-independent per-stage interpolations (one build per stage)."""
    jz_q: torch.Tensor      # (3qh, nt)   vol-quad J_z
    jz_int: torch.Tensor    # (3, 2, nt)  interior J_z at lateral qps
    jz_ext: torch.Tensor    # (3, 2, nt)  exterior (gathered) J_z
    jz_mean: torch.Tensor   # (3, 2, nt)  {J_z}
    alpha: torch.Tensor     # (3, 2, nt)  {Jz/H} lateral coefficient
    H_int: torch.Tensor     # (3, 2, nt)  column height edge states
    H_ext: torch.Tensor
    eta_int: torch.Tensor   # (3, 2, nt)  free-surface edge states
    eta_ext: torch.Tensor
    sigma3: torch.Tensor    # (3, nt)     interior-penalty coefficient


@dataclasses.dataclass(frozen=True)
class TransportCache:
    """Per-transport interpolations (one build per transport per stage)."""
    qxq: torch.Tensor       # (nl, 2qz, 3qh, nt) vol-quad transport
    qyq: torch.Tensor
    flux: dg3d.LateralFlux


def stage_cache(geom: G.Geom2D, vge: VertGeom,
                h_min: float = 0.05) -> EdgeCache:
    """Build the per-stage EdgeCache from the evaluation-mesh geometry: the
    only place a stage gathers exterior states of jz, Jz/H, H and eta."""
    jz_int = G.edge_interp(vge.jz)
    jz_ext = G.edge_interp_ext(geom, vge.jz)
    a = vge.jz / torch.clamp(vge.H, min=h_min)
    return EdgeCache(
        jz_q=G.vol_interp(vge.jz),
        jz_int=jz_int, jz_ext=jz_ext, jz_mean=0.5 * (jz_int + jz_ext),
        alpha=0.5 * (G.edge_interp(a) + G.edge_interp_ext(geom, a)),
        H_int=G.edge_interp(vge.H),
        H_ext=G.edge_interp_ext(geom, vge.H),
        eta_int=G.edge_interp(vge.eta),
        eta_ext=G.edge_interp_ext(geom, vge.eta),
        sigma3=dg3d.sigma3_lateral(geom))


def transport_cache(geom: G.Geom2D, vge: VertGeom, vg, cache: EdgeCache,
                    qx: torch.Tensor, qy: torch.Tensor,
                    fbar_edge=None, qbar2d=None,
                    h_min: float = 0.05) -> TransportCache:
    """Flux speeds + vol-quad interpolation of one transport, sharing the
    stage's EdgeCache.  The free surface and bathymetry are taken from vge /
    vg, from which the cached eta/H edge states were built."""
    flux = dg3d.lateral_flux_speed(
        geom, vge, vg, qx, qy, vge.eta, vg.b, fbar_edge=fbar_edge,
        qbar2d=qbar2d, h_min=h_min, cache=cache)
    return TransportCache(qxq=G.vol_interp(dg3d.zinterp(qx)),
                          qyq=G.vol_interp(dg3d.zinterp(qy)), flux=flux)


def concat_states(a: dg3d.FieldStates, b: dg3d.FieldStates) -> dg3d.FieldStates:
    """Stack two FieldStates along the field axis (batched advection input)."""
    return dg3d.FieldStates(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def advdiff_momentum_tracers(geom: G.Geom2D, vge: VertGeom, nl: int,
                             u_pair: torch.Tensor, tr_pair: torch.Tensor,
                             qx: torch.Tensor, qy: torch.Tensor,
                             flux: dg3d.LateralFlux,
                             nu_m: torch.Tensor, nu_tr: torch.Tensor,
                             cache: EdgeCache, tcache: TransportCache,
                             fs_u=None, fs_tr=None, diff_u=None,
                             open_tr=None, backend=None):
    """Momentum + tracer horizontal RHS sharing one LateralFlux (q-bar).

    fs_u / fs_tr are the per-stage FieldStates (fs_u is shared with the
    momentum prediction); diff_u is the momentum diffusion term if the stage
    already built it.  open_tr is the optional (2, nl, 6, nt) open-boundary
    tracer forcing, used only when fs_tr is not prebuilt.

    On the kernel backends (plain, cuda) the advection runs as ONE
    k=4-stacked call of the lateral-flux kernel; the ref backend keeps two
    advection calls.

    Returns (f3h_momentum (2, ...), f3h_tracers (2, ...))."""
    if fs_u is None:
        fs_u = dg3d.field_states(geom, u_pair, bc_reflect=True)
    if fs_tr is None:
        fs_tr = dg3d.field_states(geom, tr_pair, open_values=open_tr)
    if dispatch.resolve(backend, u_pair.device) is dispatch.Backend.REF:
        adv_m = dg3d.horizontal_advection(geom, vge, nl, u_pair, qx, qy, flux,
                                          tcache, fs_u, backend=backend)
        adv_t = dg3d.horizontal_advection(geom, vge, nl, tr_pair, qx, qy, flux,
                                          tcache, fs_tr, backend=backend)
    else:
        f = torch.cat([u_pair, tr_pair], dim=0)
        adv = dg3d.horizontal_advection(geom, vge, nl, f, qx, qy, flux, tcache,
                                        concat_states(fs_u, fs_tr),
                                        backend=backend)
        adv_m, adv_t = adv[:2], adv[2:]
    if diff_u is None:
        diff_u = dg3d.horizontal_diffusion(geom, vge, nl, u_pair, nu_m,
                                           cache, fs_u)
    diff_t = dg3d.horizontal_diffusion(geom, vge, nl, tr_pair, nu_tr,
                                       cache, fs_tr)
    return adv_m + diff_u, adv_t + diff_t
