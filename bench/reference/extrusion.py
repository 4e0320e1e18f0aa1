"""Vertical extrusion: prismatic columns over the 2D mesh (paper §1, Fig. 1b);
a frozen copy of the port's `core/extrusion.py` for the plain reference.

sigma-layer vertical grid: each column of prisms follows the free surface
with uniformly spaced layers, so the layer thickness is dz = H/nl per
horizontal node and the vertical Jacobian J_z = H/(2 nl) is a
P1-in-horizontal field, constant within a column in zeta.

3D DG fields: (nl, 6, nt); nodes 0..2 = top face, 3..5 = bottom face
(horizontal node order matches the 2D mesh). Layer 0 is the surface layer.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VGrid:
    """Static vertical grid description."""
    b: torch.Tensor                     # (3, nt) bathymetry at 2D nodes
    nl: int

    @property
    def nt(self) -> int:
        return self.b.shape[-1]


@dataclasses.dataclass(frozen=True)
class VertGeom:
    """Time-dependent vertical geometry for a given free surface eta."""
    H: torch.Tensor        # (3, nt) column height
    jz: torch.Tensor       # (3, nt) vertical jacobian H/(2 nl), same for all layers
    eta: torch.Tensor      # (3, nt)


def layer_geometry(vg: VGrid, eta: torch.Tensor,
                   h_min: float = 0.05) -> VertGeom:
    H = torch.clamp(eta + vg.b, min=h_min)
    return VertGeom(H=H, jz=H / (2.0 * vg.nl), eta=eta)


def _levels(nl: int, like: torch.Tensor) -> torch.Tensor:
    """(nl+1, 1, 1) tensor of k/nl, k = 0..nl."""
    k = torch.arange(nl + 1, dtype=like.dtype, device=like.device)
    return (k / nl)[:, None, None]


def interface_z(vg: VGrid, vge: VertGeom) -> torch.Tensor:
    """(nl+1, 3, nt) interface elevations z_k = eta - H*k/nl, k=0..nl."""
    return vge.eta[None] - vge.H[None] * _levels(vg.nl, vge.H)


def mesh_velocity(vg: VGrid, eta0: torch.Tensor, eta1: torch.Tensor,
                  dt: float) -> torch.Tensor:
    """w_m at interfaces, (nl+1, 3, nt): d z_k/dt = eta_dot * (1 - k/nl).

    Linear in zeta within each layer -> the discrete GCL holds exactly."""
    etad = (eta1 - eta0) / dt
    return etad[None] * (1.0 - _levels(vg.nl, eta0))


# --- 3D node/field helpers ---------------------------------------------------
def expand2d(f2d: torch.Tensor, nl: int) -> torch.Tensor:
    """Broadcast a 2D nodal field (..., 3, nt) to a 3D field (..., nl, 6, nt)."""
    f6 = torch.cat([f2d, f2d], dim=-2)
    return f6[..., None, :, :].expand(*f6.shape[:-2], nl, 6, f6.shape[-1])


def vsum_dofs(f3d: torch.Tensor) -> torch.Tensor:
    """Sum over vertical DOFs: (..., nl, 6, nt) -> (..., 3, nt).

    With q := J_z u projected to P1, this is the discrete vertical integral
    (paper eq. 18): sum_l (q_top + q_bot) at each horizontal node."""
    return f3d[..., :3, :].sum(dim=-3) + f3d[..., 3:, :].sum(dim=-3)


def node_z(vg: VGrid, vge: VertGeom) -> torch.Tensor:
    """z at the 6 nodes of each prism: (nl, 6, nt)."""
    zi = interface_z(vg, vge)
    return torch.cat([zi[:-1], zi[1:]], dim=1)
