"""Ocean-path entry points of the kernels, with backend dispatch.

Each op takes the stepper's SoA shapes and routes by `dispatch.Backend`:

  * ref   — the plain column solvers of `core/vertical.py`,
  * plain — the kernel's plain PyTorch version (same shapes as the kernel),
  * cuda  — the hand-written CUDA kernel.

The kernels take the SoA tensors as the stepper holds them: a leading
component axis is part of the kernel's thread index, so no fold / tile
copies are made.  ``LAUNCHES[(op, backend)]`` counts calls: the CUDA
wrappers count their own launches, this module counts ref and plain calls.
"""
from __future__ import annotations

import math

import torch

from . import column_solve, dispatch, horizontal_flux, matrix_free
from .dispatch import LAUNCHES, Backend, reset_launches  # noqa: F401


def _components(F: torch.Tensor, bc):
    """(..., nl, 6, nt) -> (K, nl, 6, nt) and bc (..., 3, nt) -> (K, 3, nt)."""
    *lead, nl, six, nt = F.shape
    K = math.prod(lead)
    Fk = F.reshape(K, nl, six, nt).contiguous()
    if bc is not None:
        bc = bc.expand(*lead, 3, nt).reshape(K, 3, nt).contiguous()
    return Fk, bc


def solve_r(geom, F, r_surf, backend: dispatch.BackendLike = None):
    """Matrix-free D_vu solve: F (..., nl, 6, nt); r_surf (..., 3, nt)."""
    from ..core import vertical
    bk = dispatch.resolve(backend, F.device)
    if bk is Backend.REF:
        LAUNCHES[("solve_r", "ref")] += 1
        return vertical.solve_r(geom, F, r_surf)
    Fk, bc = _components(F, r_surf)
    if bk is Backend.PLAIN:
        LAUNCHES[("solve_r", "plain")] += 1
        out = matrix_free.solve_r_plain(Fk, geom.area, bc)
    else:
        out = matrix_free.solve_r(Fk, geom.area, bc)
    return out.reshape(F.shape)


def solve_w(geom, F, w_floor=None, backend: dispatch.BackendLike = None):
    """Matrix-free D_vd solve: F (..., nl, 6, nt); w_floor (..., 3, nt) or
    None (impermeable floor)."""
    from ..core import vertical
    bk = dispatch.resolve(backend, F.device)
    if bk is Backend.REF:
        LAUNCHES[("solve_w", "ref")] += 1
        return vertical.solve_w(geom, F, w_floor)
    Fk, bc = _components(F, w_floor)
    if bk is Backend.PLAIN:
        LAUNCHES[("solve_w", "plain")] += 1
        out = matrix_free.solve_w_plain(Fk, geom.area, bc)
    else:
        out = matrix_free.solve_w(Fk, geom.area, bc)
    return out.reshape(F.shape)


def block_thomas(blocks, rhs, backend: dispatch.BackendLike = None):
    """Block-tridiagonal column solve: blocks (nl, 6, 6, nt) each,
    rhs (k, nl, 6, nt)."""
    from ..core import vertical
    bk = dispatch.resolve(backend, rhs.device)
    if bk is Backend.REF:
        LAUNCHES[("block_thomas", "ref")] += 1
        return vertical.block_thomas_solve(blocks, rhs)
    if bk is Backend.PLAIN:
        LAUNCHES[("block_thomas", "plain")] += 1
        return column_solve.block_thomas_plain(*blocks, rhs)
    lo, dg, up = (b.contiguous() for b in blocks)
    return column_solve.block_thomas(lo, dg, up, rhs.contiguous())


def lateral_flux_term(geom, f, fext, speed,
                      backend: dispatch.BackendLike = None):
    """Fused lateral advective flux term <<phi f_up speed Jl>>.

    f: (k, nl, 6, nt) nodal fields; fext: (k, nl, 3, 2, 2, nt) post-BC
    neighbour nodal values from dg3d.edge_ext_nodal6; speed: (nl, 2, 3, 2, nt)
    signed normal flux speed shared by the k fields.  Returns (k, nl, 6, nt).
    The ref backend runs the plain version, as it has no other form."""
    bk = dispatch.resolve(backend, f.device)
    if bk is not Backend.CUDA:
        LAUNCHES[("lateral_flux", bk.value)] += 1
        return horizontal_flux.lateral_flux_plain(f, fext, speed, geom.edge_len)
    return horizontal_flux.lateral_flux(f.contiguous(), fext.contiguous(),
                                        speed.contiguous(), geom.edge_len)
