"""Unstructured 2D triangular meshes: a frozen copy of the port's
`core/mesh2d.py`, from which the benchmark makes each configuration's mesh
and bathymetry (numpy, on the host) and hands them to the program and to
the plain reference alike.

Build-time (numpy, static) mesh machinery:
  * synthetic unstructured triangulations (jittered structured grids, basins,
    channels, reef belts) — the paper's meshes (gmsh/GBR) are not
    redistributable, so benchmarks use synthetic meshes of matched size,
  * Hilbert-curve reordering of triangles (paper §2.1: cache locality of the
    SoA layout on an unstructured mesh),
  * DG connectivity: per-(triangle, edge) neighbour triangle / neighbour edge /
    orientation maps used by the flux gathers.

Conventions
-----------
Reference triangle: r0=(0,0), r1=(1,0), r2=(0,1); P1 basis
phi0 = 1-xi-eta, phi1 = xi, phi2 = eta.  Local edge e connects local nodes
(e, (e+1)%3); outward normals.  A consistently-oriented (CCW) mesh traverses a
shared edge in opposite directions from its two sides, which
`build_connectivity` asserts.

DG field layouts (tensors of the port):
  2D field: (3, nt)            [node, triangle]  — triangle index innermost
  3D field: (nl, 6, nt)        [layer, node, triangle]
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

EDGE_NODES = np.array([[0, 1], [1, 2], [2, 0]])  # local nodes of local edge e

# edge types
INTERIOR, WALL, OPEN = 0, 1, 2


# ---------------------------------------------------------------------------
# Hilbert curve ordering (paper §2.1: reorder the 2D mesh along a Hilbert
# curve so that SoA neighbour accesses stay cache-local).
# ---------------------------------------------------------------------------
def _hilbert_rot(n: int, x: np.ndarray, y: np.ndarray, rx: np.ndarray, ry: np.ndarray):
    """Rotate/flip quadrant (vectorised classic Hilbert rotation)."""
    mask = ry == 0
    flip = mask & (rx == 1)
    x = np.where(flip, n - 1 - x, x)
    y = np.where(flip, n - 1 - y, y)
    xs = np.where(mask, y, x)
    ys = np.where(mask, x, y)
    return xs, ys


def hilbert_index(px: np.ndarray, py: np.ndarray, order: int = 16) -> np.ndarray:
    """Hilbert index of points scaled to a 2**order x 2**order grid."""
    n = 1 << order
    def scale(p):
        lo, hi = p.min(), p.max()
        span = max(hi - lo, 1e-30)
        return np.minimum((n - 1), ((p - lo) / span * (n - 1)).astype(np.int64))
    x, y = scale(px), scale(py)
    d = np.zeros_like(x)
    s = n >> 1
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        x, y = _hilbert_rot(s, x, y, rx, ry)
        s >>= 1
    return d


# ---------------------------------------------------------------------------
# Mesh container
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """Static unstructured triangular mesh with DG connectivity."""

    xy: np.ndarray          # (nv, 2) vertex coordinates
    tri: np.ndarray         # (nt, 3) vertex indices, CCW
    neigh_tri: np.ndarray   # (nt, 3) neighbour triangle per local edge (self if boundary)
    neigh_edge: np.ndarray  # (nt, 3) local edge index in the neighbour
    edge_type: np.ndarray   # (nt, 3) INTERIOR / WALL / OPEN

    @property
    def nt(self) -> int:
        return self.tri.shape[0]

    @property
    def nv(self) -> int:
        return self.xy.shape[0]

    # -- geometry ----------------------------------------------------------
    def node_xy(self) -> np.ndarray:
        """(nt, 3, 2) coordinates of the 3 P1 nodes of each triangle."""
        return self.xy[self.tri]

    def areas(self) -> np.ndarray:
        p = self.node_xy()
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        return 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])

    def centroids(self) -> np.ndarray:
        return self.node_xy().mean(axis=1)

    # -- transforms ----------------------------------------------------------
    def reorder(self, perm: np.ndarray) -> "Mesh2D":
        """Permute triangles: new triangle i = old triangle perm[i]."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        return Mesh2D(
            xy=self.xy,
            tri=self.tri[perm],
            neigh_tri=inv[self.neigh_tri[perm]],
            neigh_edge=self.neigh_edge[perm],
            edge_type=self.edge_type[perm],
        )

    def hilbert_reorder(self) -> "Mesh2D":
        c = self.centroids()
        perm = np.argsort(hilbert_index(c[:, 0], c[:, 1]), kind="stable")
        return self.reorder(perm)

    def validate(self) -> None:
        a = self.areas()
        assert (a > 0).all(), f"{(a <= 0).sum()} inverted/degenerate triangles"
        nt = self.nt
        assert self.neigh_tri.shape == (nt, 3)
        # interior edges must be mutual with opposite orientation
        for e in range(3):
            interior = self.edge_type[:, e] == INTERIOR
            t = np.arange(nt)[interior]
            n = self.neigh_tri[interior, e]
            ne = self.neigh_edge[interior, e]
            assert (self.neigh_tri[n, ne] == t).all(), "connectivity not mutual"
            a_, b_ = EDGE_NODES[e].T
            my_a = self.tri[t, EDGE_NODES[e][0]]
            my_b = self.tri[t, EDGE_NODES[e][1]]
            th_a = self.tri[n, EDGE_NODES[ne, 0]]
            th_b = self.tri[n, EDGE_NODES[ne, 1]]
            assert (my_a == th_b).all() and (my_b == th_a).all(), (
                "shared edge not traversed in opposite directions")


def build_connectivity(tri: np.ndarray, open_edge_fn: Optional[Callable] = None,
                       xy: Optional[np.ndarray] = None) -> Mesh2D:
    """Derive neighbour maps from a (nt,3) CCW triangle list.

    open_edge_fn(midpoints: (k,2)) -> bool mask marks boundary edges as OPEN
    instead of WALL.
    """
    nt = tri.shape[0]
    # undirected edge key -> (tri, local_edge)
    a = tri[:, EDGE_NODES[:, 0]]  # (nt,3)
    b = tri[:, EDGE_NODES[:, 1]]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo.astype(np.int64) * (tri.max() + 1) + hi.astype(np.int64)
    flat = key.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_keys = flat[order]
    neigh_tri = np.tile(np.arange(nt)[:, None], (1, 3))
    neigh_edge = np.tile(np.arange(3)[None, :], (nt, 1))
    edge_type = np.full((nt, 3), WALL, dtype=np.int64)

    # pairs of identical keys are the two sides of an interior edge
    same = sorted_keys[:-1] == sorted_keys[1:]
    i0 = order[:-1][same]
    i1 = order[1:][same]
    t0, e0 = i0 // 3, i0 % 3
    t1, e1 = i1 // 3, i1 % 3
    neigh_tri[t0, e0] = t1
    neigh_edge[t0, e0] = e1
    neigh_tri[t1, e1] = t0
    neigh_edge[t1, e1] = e0
    edge_type[t0, e0] = INTERIOR
    edge_type[t1, e1] = INTERIOR

    if open_edge_fn is not None and xy is not None:
        bnd = edge_type == WALL
        tb, eb = np.nonzero(bnd)
        mids = 0.5 * (xy[tri[tb, EDGE_NODES[eb, 0]]] + xy[tri[tb, EDGE_NODES[eb, 1]]])
        is_open = open_edge_fn(mids)
        edge_type[tb[is_open], eb[is_open]] = OPEN

    m = Mesh2D(xy=xy, tri=tri, neigh_tri=neigh_tri, neigh_edge=neigh_edge,
               edge_type=edge_type)
    return m


# ---------------------------------------------------------------------------
# Synthetic mesh factories
# ---------------------------------------------------------------------------
def rect_mesh(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0,
              jitter: float = 0.0, seed: int = 0,
              open_edge_fn: Optional[Callable] = None,
              hilbert: bool = True) -> Mesh2D:
    """Jittered structured triangulation of [0,lx]x[0,ly]: 2*nx*ny triangles.

    jitter in [0, ~0.25] moves interior vertices by jitter*h to make the mesh
    genuinely unstructured (irregular angles/areas) while provably valid.
    """
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    xy = np.stack([X.ravel(), Y.ravel()], axis=1)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        hx, hy = lx / nx, ly / ny
        interior = ((X > 0) & (X < lx) & (Y > 0) & (Y < ly)).ravel()
        d = rng.uniform(-1, 1, size=xy.shape) * np.array([hx, hy]) * jitter
        xy = xy + d * interior[:, None]

    def vid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            if (i + j) % 2 == 0:  # alternate diagonals (union-jack-ish)
                tris.append([v00, v10, v11])
                tris.append([v00, v11, v01])
            else:
                tris.append([v00, v10, v01])
                tris.append([v10, v11, v01])
    tri = np.array(tris, dtype=np.int64)
    m = build_connectivity(tri, open_edge_fn=open_edge_fn, xy=xy)
    m.validate()
    if hilbert:
        m = m.hilbert_reorder()
    return m


# ---------------------------------------------------------------------------
# Bathymetries (positive depth below reference level)
# ---------------------------------------------------------------------------
def reef_bathymetry(h_shallow: float, h_deep: float, lx: float, ly: float,
                    n_reefs: int = 40, seed: int = 3) -> Callable:
    """Reef-belt bathymetry (GBR-like §5): shelf + gaussian reef bumps."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0.15 * lx, 0.6 * lx, n_reefs)
    cy = rng.uniform(0.05 * ly, 0.95 * ly, n_reefs)
    rr = rng.uniform(0.01, 0.03, n_reefs) * min(lx, ly)

    def f(p):
        s = np.clip(p[:, 0] / lx, 0, 1)
        h = h_shallow + (h_deep - h_shallow) * s ** 2
        for k in range(n_reefs):
            d2 = (p[:, 0] - cx[k]) ** 2 + (p[:, 1] - cy[k]) ** 2
            h = h - (h - h_shallow * 0.3) * 0.8 * np.exp(-d2 / (2 * rr[k] ** 2))
        return np.maximum(h, 0.2 * h_shallow)
    return f
