"""Physics monitors: a ``Diagnostics`` bundle of 0-d tensors computed on the
device right after a step, and a host-side ``MonitorPolicy``.

The monitors are the quantities that tell you a run has gone physically
wrong before the output does:

  * total water volume  ∫ H dA          (exactly conserved in a closed basin)
  * tracer masses       ∫ T dV, ∫ S dV  (conserved to roundoff by the scheme)
  * tracer min/max      (DG advection of a tracer must stay inside the
                         initial bounds up to the diffusion terms)
  * max |eta|, max horizontal speed
  * external-mode wave CFL  (|u| + sqrt(gH)) * dt_2d / h  per element, with
    h = 2 area / longest edge
  * a non-finite flag WITH localisation: the first offending field and the
    2D cell (triangle) it occurs in, by an argmax on the device.

All reductions stay on the device; ``to_dict`` reads the whole bundle back
in one device-to-host copy.  ``MonitorPolicy.check`` turns a bundle into
violation events: warn, halt (raise ``MonitorHalt``) or silent collection,
and mirrors everything into a metrics registry.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import trace
from ..core import geometry as G
from ..core import stepper, vertical
from ..core.extrusion import VGrid, layer_geometry

# localisation priority: first listed field wins when several go bad at once
FIELDS = ("eta", "qx", "qy", "ux", "uy", "T", "S", "turb_k", "turb_eps")


@dataclasses.dataclass(frozen=True)
class Diagnostics:
    """Scalar physics monitors for one model state (0-d tensors on the
    state's device)."""
    time: torch.Tensor         # model time [s]
    volume: torch.Tensor       # total water volume ∫ H dA [m^3]
    mass_T: torch.Tensor       # ∫ T dV (tracer content)
    mass_S: torch.Tensor
    T_min: torch.Tensor
    T_max: torch.Tensor
    S_min: torch.Tensor
    S_max: torch.Tensor
    eta_max: torch.Tensor      # max |eta| [m]
    speed_max: torch.Tensor    # max horizontal |u| [m/s]
    cfl_2d: torch.Tensor       # max external-mode wave CFL over elements
    nonfinite: torch.Tensor    # bool: any NaN/Inf in the prognostic state
    bad_field: torch.Tensor    # int64 index into FIELDS (-1 if finite)
    bad_cell: torch.Tensor     # int64 triangle index (-1 if finite)


def _colwise_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """(..., nt) -> (nt,) bool: any non-finite entry in each cell column."""
    return (~torch.isfinite(x)).reshape(-1, x.shape[-1]).any(dim=0)


def compute(geom: G.Geom2D, vg: VGrid, cfg: stepper.OceanConfig,
            st: stepper.OceanState) -> Diagnostics:
    """The monitor bundle of ``st``, computed on its device."""
    vge = layer_geometry(vg, st.ext.eta, cfg.h_min)

    # conservation integrals: ∫ of a P1 field over a triangle is
    # area * mean(vertex values); tracer content uses the same 3D mass
    # matrix the stepper conserves with
    volume = (geom.area * vge.H.mean(dim=0)).sum()
    mass_T = vertical.mass_apply3d(geom, vge.jz, st.T).sum()
    mass_S = vertical.mass_apply3d(geom, vge.jz, st.S).sum()

    speed2 = st.ux ** 2 + st.uy ** 2
    speed_max = torch.sqrt(speed2.max())

    # external-mode wave CFL per element: the 2D burst runs m_2d substeps
    # per internal dt, element length scale h = 2 area / longest edge
    dt2d = cfg.dt / max(cfg.m_2d, 1)
    h = 2.0 * geom.area / geom.edge_len.amax(dim=0)
    c = torch.sqrt(G.G_GRAV * vge.H.amax(dim=0))
    umax_el = torch.sqrt(speed2.reshape(-1, geom.nt).amax(dim=0))
    cfl_2d = ((c + umax_el) * dt2d / h).max()

    # non-finite localisation: stack per-cell badness of every prognostic
    # field; row-major argmax -> (first bad field, first bad cell in it)
    fields = dict(eta=st.ext.eta, qx=st.ext.qx, qy=st.ext.qy,
                  ux=st.ux, uy=st.uy, T=st.T, S=st.S,
                  turb_k=st.turb_k, turb_eps=st.turb_eps)
    bad = torch.stack([_colwise_nonfinite(fields[f]) for f in FIELDS])
    any_bad = bad.any()
    idx = torch.argmax(bad.reshape(-1).to(torch.uint8))
    nt = geom.nt
    minus1 = torch.full_like(idx, -1)
    bad_field = torch.where(any_bad, idx // nt, minus1)
    bad_cell = torch.where(any_bad, idx % nt, minus1)

    return Diagnostics(
        time=st.time, volume=volume, mass_T=mass_T, mass_S=mass_S,
        T_min=st.T.min(), T_max=st.T.max(),
        S_min=st.S.min(), S_max=st.S.max(),
        eta_max=st.ext.eta.abs().max(), speed_max=speed_max,
        cfl_2d=cfl_2d, nonfinite=any_bad, bad_field=bad_field,
        bad_cell=bad_cell)


def step_with_diagnostics(geom: G.Geom2D, vg: VGrid,
                          cfg: stepper.OceanConfig, st: stepper.OceanState,
                          forcing: Optional[stepper.Forcing3D] = None,
                          **kw) -> Tuple[stepper.OceanState, Diagnostics]:
    """One stepper.step and the monitor bundle of the NEW state."""
    if forcing is None:
        forcing = stepper.Forcing3D()
    st1 = stepper.step(geom, vg, cfg, st, forcing, **kw)
    with trace.annotate("obs.diagnostics"):
        diag = compute(geom, vg, cfg, st1)
    return st1, diag


_INT_FIELDS = ("bad_field", "bad_cell")


def to_dict(diag: Diagnostics) -> Dict[str, Any]:
    """Host-side python scalars, read back in one device-to-host copy (the
    integers are below 2^53, so float64 carries them exactly)."""
    names = [f.name for f in dataclasses.fields(Diagnostics)]
    vals = torch.stack([getattr(diag, n).detach().to(torch.float64)
                        for n in names]).tolist()
    out: Dict[str, Any] = {}
    for name, v in zip(names, vals):
        if name == "nonfinite":
            out[name] = bool(v)
        elif name in _INT_FIELDS:
            out[name] = int(v)
        else:
            out[name] = float(v)
    bf = out["bad_field"]
    out["bad_field_name"] = FIELDS[bf] if 0 <= bf < len(FIELDS) else None
    return out


class MonitorHalt(RuntimeError):
    """Raised by MonitorPolicy(on_violation='halt'); carries the diagnostics
    dict so fault handling can log/act on the physics reason."""

    def __init__(self, violations: List[dict], diag: Dict[str, Any]):
        self.violations = violations
        self.diagnostics = diag
        super().__init__("physics monitor violation: " + "; ".join(
            v["rule"] + (f" ({v['detail']})" if v.get("detail") else "")
            for v in violations))


@dataclasses.dataclass
class MonitorPolicy:
    """Host-side thresholds + what to do when one trips.

    ``on_violation``: "warn" (warnings.warn, keep running), "halt" (raise
    MonitorHalt), or "silent" (collect only, caller inspects the return).
    Conservation drift limits are relative to the reference values captured
    on the FIRST check (or set explicitly via ``reference``)."""
    cfl_max: Optional[float] = 1.0
    eta_max: Optional[float] = None          # [m]
    speed_max: Optional[float] = None        # [m/s]
    tracer_bounds: Optional[Dict[str, Tuple[float, float]]] = None
    volume_drift_max: Optional[float] = None     # relative
    mass_drift_max: Optional[float] = None       # relative, T and S
    on_violation: str = "warn"
    reference: Optional[Dict[str, float]] = None

    def check(self, diag, step: Optional[int] = None,
              registry=None) -> List[dict]:
        """Evaluate all configured rules; emit events; warn/halt per policy.

        ``diag`` is a Diagnostics bundle or an already-converted dict."""
        d = diag if isinstance(diag, dict) else to_dict(diag)
        if self.reference is None:
            self.reference = {k: d[k] for k in ("volume", "mass_T", "mass_S")}
        v: List[dict] = []

        def rule(name, value, limit, detail=""):
            v.append(dict(rule=name, value=value, limit=limit, detail=detail))

        if d["nonfinite"]:
            rule("nonfinite", 1.0, 0.0,
                 f"field={d['bad_field_name']} cell={d['bad_cell']}")
        if self.cfl_max is not None and d["cfl_2d"] > self.cfl_max:
            rule("cfl_2d", d["cfl_2d"], self.cfl_max)
        if self.eta_max is not None and d["eta_max"] > self.eta_max:
            rule("eta_max", d["eta_max"], self.eta_max)
        if self.speed_max is not None and d["speed_max"] > self.speed_max:
            rule("speed_max", d["speed_max"], self.speed_max)
        for tr, (lo, hi) in (self.tracer_bounds or {}).items():
            if d[f"{tr}_min"] < lo:
                rule(f"{tr}_min", d[f"{tr}_min"], lo, "monotonicity floor")
            if d[f"{tr}_max"] > hi:
                rule(f"{tr}_max", d[f"{tr}_max"], hi, "monotonicity ceiling")
        for key, lim in (("volume", self.volume_drift_max),
                         ("mass_T", self.mass_drift_max),
                         ("mass_S", self.mass_drift_max)):
            if lim is None:
                continue
            ref = self.reference[key]
            drift = abs(d[key] - ref) / max(abs(ref), 1e-30)
            if drift > lim:
                rule(f"{key}_drift", drift, lim)

        if registry is not None:
            registry.diagnostics("physics", d, step=step)
            for viol in v:
                registry.event("monitor.violation", viol, step=step)
        if v:
            if self.on_violation == "halt":
                raise MonitorHalt(v, d)
            if self.on_violation == "warn":
                warnings.warn(
                    "physics monitor violation(s): "
                    + "; ".join(f"{x['rule']}={x['value']:.4g} "
                                f"(limit {x['limit']:.4g})" for x in v),
                    RuntimeWarning, stacklevel=2)
        return v
