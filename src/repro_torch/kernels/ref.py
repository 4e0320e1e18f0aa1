"""Plain references of the cell-layout kernels: the `ref` backend of the
cell-layout ops in `ops.py` (the counterparts of the JAX package's
`kernels/ref.py`, ocean part).

Each function computes what its kernel computes, in the cell layout's
shapes, from the column solvers of `core/` rather than from the kernel's
own plain version, so that `ref` and `plain` are two independent forms.
"""
from __future__ import annotations

import torch

from ..core import layout


def tridiag(dl, d, du, b):
    """Thomas solve, (nl, C) operands; see kernels/tridiag.py."""
    from ..core.turbulence import thomas_solve
    return thomas_solve(dl, d, du, b)


def _minv_faces(F, area):
    """M_h^{-1} of the top and bottom faces of F (nl*6, C), area (1, C)."""
    rows, C = F.shape
    Ff = F.reshape(rows // 6, 6, C)
    inva = 12.0 / area

    def minv(face):
        # face (nl, 3, C): M_h^{-1} mixes the 3 nodes of each face
        return inva * (face - 0.25 * face.sum(dim=1, keepdim=True))
    return minv(Ff[:, 0:3, :]), minv(Ff[:, 3:6, :])


def solve_r_cell(F, area, r_surf):
    """Matrix-free D_vu solve in cell layout: F (nl*6, C), area (1, C),
    r_surf (3, C)."""
    gt, gb = _minv_faces(F, area)
    rb = r_surf[None] - torch.cumsum(gt + gb, dim=0)
    return torch.cat([rb + 2.0 * gb, rb], dim=1).reshape(F.shape)


def solve_w_cell(F, area, w_floor):
    """Matrix-free D_vd solve in cell layout: F (nl*6, C), area (1, C),
    w_floor (3, C)."""
    gt, gb = _minv_faces(F, area)
    s = torch.flip(torch.cumsum(torch.flip(gt + gb, [0]), dim=0), [0])
    wt = w_floor[None] + s
    return torch.cat([wt, wt - 2.0 * gt], dim=1).reshape(F.shape)


def block_thomas_cell(lo, dg, up, b):
    """Block-tridiagonal solve: lo/dg/up (nl, 6, 6, C), b (nl, 6, k, C)."""
    from ..core.vertical import Blocks, block_thomas_solve
    rhs = torch.movedim(b, 2, 0)               # (k, nl, 6, C)
    x = block_thomas_solve(Blocks(lo=lo, dg=dg, up=up), rhs)
    return torch.movedim(x, 0, 2)


def soa_to_cell(x):
    """(nl, 6, nt) -> (nc, nl*6, 128)."""
    return layout.soa_to_cell(x)


def cell_to_soa(x, nt):
    """(nc, nl*6, 128) -> (nl, 6, nt)."""
    _, rows, _ = x.shape
    return layout.cell_to_soa(x, rows // 6, 6, nt)
