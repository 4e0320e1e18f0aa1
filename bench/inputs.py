"""The inputs of a run, made by the benchmark and handed alike to the
program and to the plain reference: the configuration's mesh and
bathymetry (fixed by the configuration, made on the host), and the
seeded initial state and forcing (made on the device from ``--seed``).

The seed moves only smooth, small parts of the initial state (the front's
position and strength, a basin-scale mode of the free surface, the tide's
amplitude), so the sub-step count and the work a step does are the same on
every seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .reference import mesh2d


@dataclasses.dataclass(frozen=True)
class Inputs:
    mesh: mesh2d.Mesh2D
    b: np.ndarray                 # (3, nt) bathymetry [m], float64
    nl: int
    m_2d: int
    case: dict                    # the configuration file
    eta: torch.Tensor             # (3, nt) initial free surface, float64
    T: torch.Tensor               # (nl, 6, nt) initial temperature, float64
    tide_amp: Optional[float]     # open-boundary tide amplitude [m], or None


def make_mesh(case: dict) -> mesh2d.Mesh2D:
    """The configuration's jittered rect_mesh (Hilbert-ordered), with an
    open boundary at x = lx where the configuration has one."""
    m = case["mesh"]
    open_fn = None
    if m["open_east"]:
        lx = m["lx"]
        open_fn = lambda mids: mids[:, 0] > lx * (1 - 1e-9)
    return mesh2d.rect_mesh(m["nx"], m["ny"], m["lx"], m["ly"],
                            jitter=m["jitter"], seed=m["seed"],
                            open_edge_fn=open_fn)


def bathymetry(case: dict, mesh: mesh2d.Mesh2D) -> np.ndarray:
    """Depth at the triangles' nodes, (3, nt) float64."""
    bt = case["bathymetry"]
    if bt["kind"] == "flat":
        return np.full((3, mesh.nt), float(bt["depth"]))
    if bt["kind"] == "reef":
        m = case["mesh"]
        f = mesh2d.reef_bathymetry(bt["depth_shallow"], bt["depth_deep"],
                                   m["lx"], m["ly"], n_reefs=bt["n_reefs"],
                                   seed=bt["seed"])
        p = mesh.node_xy()                               # (nt, 3, 2)
        pts = np.stack([p[:, :, 0].T.ravel(), p[:, :, 1].T.ravel()], 1)
        return f(pts).reshape(3, mesh.nt)
    raise ValueError(f"unknown bathymetry kind {bt['kind']!r}")


def make_inputs(case: dict, traffic: dict, seed: int,
                device: torch.device) -> Inputs:
    """Mesh, bathymetry and the seeded initial state of one run."""
    mesh = make_mesh(case)
    nl, nt = traffic["nl"], mesh.nt
    f64 = dict(dtype=torch.float64, device=device)
    p = mesh.node_xy()
    x = torch.as_tensor(np.ascontiguousarray(p[:, :, 0].T), **f64)
    y = torch.as_tensor(np.ascontiguousarray(p[:, :, 1].T), **f64)
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    u = torch.rand(6, generator=g, **f64)
    s = case["seeded"]
    lx, ly = case["mesh"]["lx"], case["mesh"]["ly"]
    mode = (torch.cos(2 * math.pi * (x / lx + u[2]))
            * torch.cos(2 * math.pi * (y / ly + u[3])))
    eta = s["eta_amp"] * mode
    if case["case"] == "front":
        fr = case["front"]
        x_front = lx / 2 + (2 * u[0] - 1) * s["front_shift"]
        dT = fr["dT"] * (1 + (2 * u[1] - 1) * s["dT_rel"])
        T2 = case["T0"] + dT * torch.tanh((x_front - x) / fr["width"])
        tide_amp = None
    else:
        T2 = case["T0"] + s["T_amp"] * (2 * u[0] - 1) * mode
        tide_amp = case["forcing"]["tide_amp"] * (
            1 + (2 * float(u[1]) - 1) * s["tide_amp_rel"])
    T = torch.cat([T2, T2])[None].expand(nl, 6, nt).contiguous()
    return Inputs(mesh=mesh, b=bathymetry(case, mesh), nl=nl,
                  m_2d=traffic["m_2d"], case=case, eta=eta, T=T,
                  tide_amp=tide_amp)
