"""DG P1 geometry + quadrature machinery (2D triangles, extruded prisms):
a frozen copy of the port's `core/geometry.py` for the plain reference.

Static mesh data lives in `mesh2d.Mesh2D` (numpy) and is turned into a
`Geom2D` of tensors once at setup, on the device the run uses.

Layout conventions (the triangle index is always the innermost axis: it is
the long, contiguous dimension, so neighbouring CUDA threads read
neighbouring addresses):
  2D scalar field      f     : (3, nt)            [node, tri]
  2D vector field      v     : (2, 3, nt)         [comp, node, tri]
  3D scalar field      T     : (nl, 6, nt)        [layer, node, tri]
  3D vector field      u     : (2, nl, 6, nt)
  edge-quad values           : (3, 2, nt)         [edge, qp, tri]

Quadrature (used uniformly for ALL terms so that discrete consistency —
free-surface vs continuity, tracer constancy — holds exactly):
  * triangle volume: 3 edge-midpoint points, weight A/3 (exact to degree 2)
  * edge: 2-point Gauss (exact to degree 3)
  * vertical: 2-point Gauss on [-1, 1]

The small constant contractions (volume interpolation, edge interpolation,
edge scatter) are written out as sums of scalar multiples, so the constants
never travel to the device as tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import mesh2d
from .mesh2d import EDGE_NODES, INTERIOR, OPEN, WALL

G_GRAV = 9.81

# local node ids of each local edge
EDGE_A = np.array([0, 1, 2])
EDGE_B = np.array([1, 2, 0])

# 2-point Gauss on s in [0,1]
S_GAUSS = np.array([0.5 - np.sqrt(3) / 6, 0.5 + np.sqrt(3) / 6])
W_GAUSS = np.array([0.5, 0.5])  # times edge length

# 2-point Gauss on zeta in [-1,1] (for vertical integration; weight 1 each)
Z_GAUSS = np.array([-1 / np.sqrt(3), 1 / np.sqrt(3)])

# triangle volume quadrature: edge midpoints, weights A/3
#   PHI_VQ[q, i] = phi_i(x_q)
PHI_VQ = np.array([[0.5, 0.5, 0.0],
                   [0.0, 0.5, 0.5],
                   [0.5, 0.0, 0.5]])

# vertical P1 basis at the 2 Gauss points: row=qp, col=(top, bot)
PHI_ZQ = np.stack([(1 + Z_GAUSS) / 2, (1 - Z_GAUSS) / 2], axis=1)  # (2,2)

# edge basis of nodes a / b at the 2 edge Gauss points
PHIA = 1.0 - S_GAUSS
PHIB = S_GAUSS

# scatter tensor: EDGE_SCATTER[e, q, n] = w_q * phi_n(s_q) on edge e
EDGE_SCATTER = np.zeros((3, 2, 3))
for _e in range(3):
    EDGE_SCATTER[_e, :, EDGE_A[_e]] += W_GAUSS * PHIA
    EDGE_SCATTER[_e, :, EDGE_B[_e]] += W_GAUSS * PHIB


def lincomb(coefs, xs):
    """sum_i coefs[i] * xs[i] over the nonzero coefficients (python floats,
    so no constant tensor is built)."""
    acc = None
    for c, x in zip(coefs, xs):
        c = float(c)
        if c != 0.0:
            term = c * x
            acc = term if acc is None else acc + term
    return acc


@dataclasses.dataclass(frozen=True)
class Geom2D:
    """Static per-triangle geometry + DG connectivity gathers."""

    area: torch.Tensor       # (nt,)
    jh: torch.Tensor         # (nt,)  = 2*area
    dphi: torch.Tensor       # (3, 2, nt) physical gradients of P1 basis
    node_x: torch.Tensor     # (3, nt)
    node_y: torch.Tensor     # (3, nt)
    edge_len: torch.Tensor   # (3, nt)
    edge_nx: torch.Tensor    # (3, nt) outward unit normal
    edge_ny: torch.Tensor    # (3, nt)
    ext_tri: torch.Tensor    # (3, nt) int64 — neighbour triangle (self at boundary)
    ext_na: torch.Tensor     # (3, nt) int64 — neighbour-local node facing my node a
    ext_nb: torch.Tensor     # (3, nt) int64 — neighbour-local node facing my node b
    wall: torch.Tensor       # (3, nt) 1.0 on WALL edges
    openb: torch.Tensor      # (3, nt) 1.0 on OPEN edges

    @property
    def nt(self) -> int:
        return self.area.shape[-1]

    @property
    def interior(self) -> torch.Tensor:
        return 1.0 - self.wall - self.openb


def geom2d_from_mesh(mesh: mesh2d.Mesh2D, dtype=torch.float32,
                     device=None) -> Geom2D:
    """Per-triangle geometry of ``mesh`` as tensors on ``device``."""
    p = mesh.node_xy()                      # (nt, 3, 2)
    area = mesh.areas()                     # (nt,)
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]  # = 2A > 0
    # J = [[d1x, d2x],[d1y, d2y]]; J^{-1} = adj(J)/det
    inv_j = np.stack([
        np.stack([d2[:, 1], -d2[:, 0]], axis=-1),
        np.stack([-d1[:, 1], d1[:, 0]], axis=-1),
    ], axis=1) / det[:, None, None]          # (nt, 2, 2): J^{-1}
    gref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
    dphi = np.einsum("tcd,nc->ndt", inv_j, gref)  # (3, 2, nt)

    pa = p[:, EDGE_A]                       # (nt, 3, 2)
    pb = p[:, EDGE_B]
    ev = pb - pa
    elen = np.linalg.norm(ev, axis=-1)      # (nt, 3)
    # outward normal for CCW triangles: rotate edge vector by -90deg
    nx = ev[:, :, 1] / elen
    ny = -ev[:, :, 0] / elen

    # my edge (a,b) faces neighbour edge (a',b') with a<->b' and b<->a'
    ne = mesh.neigh_edge
    ext_na = EDGE_NODES[ne, 1]
    ext_nb = EDGE_NODES[ne, 0]
    bnd = mesh.edge_type != INTERIOR
    # boundary: ext node = own node (ghost state mirrors interior)
    ext_na = np.where(bnd, EDGE_NODES[np.arange(3)[None, :], 0], ext_na)
    ext_nb = np.where(bnd, EDGE_NODES[np.arange(3)[None, :], 1], ext_nb)

    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                  device=device)
    i = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64,
                                  device=device)
    return Geom2D(
        area=f(area), jh=f(2 * area), dphi=f(dphi),
        node_x=f(p[:, :, 0].T), node_y=f(p[:, :, 1].T),
        edge_len=f(elen.T), edge_nx=f(nx.T), edge_ny=f(ny.T),
        ext_tri=i(mesh.neigh_tri.T), ext_na=i(ext_na.T), ext_nb=i(ext_nb.T),
        wall=f((mesh.edge_type == WALL).T),
        openb=f((mesh.edge_type == OPEN).T))


# ---------------------------------------------------------------------------
# Elementwise DG operations (2D). Fields may have extra leading axes.
# ---------------------------------------------------------------------------
def grad2d(geom: Geom2D, f: torch.Tensor) -> torch.Tensor:
    """Constant per-triangle gradient of a P1 field: (..., 3, nt) -> (..., 2, nt)."""
    return torch.stack([
        f[..., 0, :] * geom.dphi[0, d] + f[..., 1, :] * geom.dphi[1, d]
        + f[..., 2, :] * geom.dphi[2, d] for d in range(2)], dim=-2)


def mass_apply(geom: Geom2D, f: torch.Tensor) -> torch.Tensor:
    """M f with M = (A/12)(I + ones): (..., 3, nt)."""
    s = f.sum(dim=-2, keepdim=True)
    return (geom.area / 12.0) * (f + s)


def minv_apply(geom: Geom2D, r: torch.Tensor) -> torch.Tensor:
    """M^{-1} r = (12/A)(r - sum(r)/4): (..., 3, nt)."""
    s = r.sum(dim=-2, keepdim=True)
    return (12.0 / geom.area) * (r - 0.25 * s)


def lumped_mass(geom: Geom2D) -> torch.Tensor:
    """Row-sum lumped mass (A/3 per node): (1, nt) broadcastable."""
    return (geom.area / 3.0)[None, :]


# --- edge quadrature ---------------------------------------------------------
def pick_nodes(f: torch.Tensor, nodes) -> torch.Tensor:
    """f[..., nodes, :] for a short static node list, by python-int slices."""
    return torch.stack([f[..., int(n), :] for n in nodes], dim=-2)


def edge_interp(f: torch.Tensor) -> torch.Tensor:
    """Interior values at the 2 Gauss points of the 3 edges.

    f: (..., 3, nt) nodal -> (..., 3, 2, nt) [edge, qp]."""
    fa = pick_nodes(f, EDGE_A)
    fb = pick_nodes(f, EDGE_B)
    return torch.stack([fa * PHIA[q] + fb * PHIB[q] for q in range(2)],
                       dim=-2)


def edge_ext_nodal(geom: Geom2D, f: torch.Tensor):
    """Neighbour nodal values facing my edge nodes a and b: two (..., 3, nt)."""
    fa = f[..., geom.ext_na, geom.ext_tri]
    fb = f[..., geom.ext_nb, geom.ext_tri]
    return fa, fb


def edge_interp_ext(geom: Geom2D, f: torch.Tensor) -> torch.Tensor:
    """Exterior (neighbour) values at my edge Gauss points: (..., 3, 2, nt)."""
    fa, fb = edge_ext_nodal(geom, f)
    return torch.stack([fa * PHIA[q] + fb * PHIB[q] for q in range(2)],
                       dim=-2)


def edge_scatter(geom: Geom2D, g: torch.Tensor) -> torch.Tensor:
    """Assemble edge integrals back onto nodes.

    g: (..., 3, 2, nt) integrand at edge Gauss points (WITHOUT the length
    jacobian). Returns (..., 3, nt): sum_e sum_q w_q * l_e * phi_node(s_q) * g.
    The (edge, qp) -> node accumulation runs over the 12 nonzero entries of
    EDGE_SCATTER as scalar multiples."""
    gw = g * geom.edge_len[:, None, :]
    cols = []
    for n in range(3):
        coefs, xs = [], []
        for e in range(3):
            for q in range(2):
                coefs.append(EDGE_SCATTER[e, q, n])
                xs.append(gw[..., e, q, :])
        cols.append(lincomb(coefs, xs))
    return torch.stack(cols, dim=-2)


# --- volume quadrature -------------------------------------------------------
def vol_interp(f: torch.Tensor) -> torch.Tensor:
    """Nodal (..., 3, nt) -> values at the 3 volume qps (..., 3, nt)."""
    xs = [f[..., n, :] for n in range(3)]
    return torch.stack([lincomb(PHI_VQ[q], xs) for q in range(3)], dim=-2)


def vol_scatter(geom: Geom2D, g: torch.Tensor) -> torch.Tensor:
    """∫ phi_i g over each triangle, g given at volume qps.

    g: (..., 3, nt) at qps -> (..., 3, nt) nodal coefficients."""
    xs = [g[..., q, :] for q in range(3)]
    return torch.stack([lincomb(PHI_VQ[:, n], xs) for n in range(3)],
                       dim=-2) * (geom.area / 3.0)
