"""Fused lateral advective-flux term (paper §2.2): CUDA kernel K4.

The lateral upwind advective flux evaluates the interior/exterior field
states at the 12 lateral quadrature points of each prism (2 zeta-Gauss x 3
edges x 2 edge-Gauss), selects the upwind one against the signed normal
flux speed, and scatters speed * f_up * w_q back onto the 6 prism nodes.
The kernel (`csrc/ocean_kernels.cu`: lateral_flux_kernel) runs one thread
per (field, layer, triangle) and keeps every qp intermediate in registers.
The neighbour gather stays outside the kernel (`dg3d.edge_ext_nodal6`, at
nodal width, boundary fixups applied).

Shapes (SoA):
  f         (k, nl, 6, nt)          nodal fields
  fext      (k, nl, 3, 2, 2, nt)    neighbour nodal values (edge, a|b, top|bot)
  speed     (nl, 2, 3, 2, nt)       signed normal flux speed (qz, edge, qs),
                                    shared by the k fields
  edge_len  (3, nt)                 edge lengths; w_q = edge_len * W_GAUSS[q]
  out       (k, nl, 6, nt)          <<phi f_up speed J_l>> on the 6 nodes

The interpolation constants come from `core/geometry.py` and are passed to
the kernel as arguments.  `lateral_flux` launches the kernel and takes only
CUDA tensors; `lateral_flux_plain` is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dispatch import LAUNCHES
from ..core import geometry as G


def lateral_flux_plain(f: torch.Tensor, fext: torch.Tensor,
                       speed: torch.Tensor,
                       edge_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (shapes in the module docstring)."""
    PZ = G.PHI_ZQ
    ff = f.unflatten(-2, (2, 3))                       # (k, l, top|bot, node, t)
    # zeta-interp to the 2 Gauss levels
    fzi = torch.stack([PZ[z, 0] * ff[:, :, 0] + PZ[z, 1] * ff[:, :, 1]
                       for z in range(2)], dim=2)      # (k, l, z, node, t)
    fze = torch.stack([PZ[z, 0] * fext[..., 0, :] + PZ[z, 1] * fext[..., 1, :]
                       for z in range(2)], dim=2)      # (k, l, z, e, a|b, t)
    # edge s-interp -> (k, l, z, e, qs, t)
    fia = G.pick_nodes(fzi, G.EDGE_A)
    fib = G.pick_nodes(fzi, G.EDGE_B)
    fi = torch.stack([G.PHIA[q] * fia + G.PHIB[q] * fib for q in range(2)],
                     dim=-2)
    fe = torch.stack([G.PHIA[q] * fze[..., 0, :] + G.PHIB[q] * fze[..., 1, :]
                      for q in range(2)], dim=-2)
    w = torch.stack([edge_len * G.W_GAUSS[q] for q in range(2)], dim=-2)
    g = torch.where(speed > 0, fi, fe) * speed * w     # (k, l, z, e, qs, t)
    # node scatter: EDGE_SCATTER without its W_GAUSS factor (w carries it)
    P = G.EDGE_SCATTER / G.W_GAUSS[None, :, None]
    nodes = torch.stack([
        G.lincomb([P[e, q, n] for e in range(3) for q in range(2)],
                  [g[..., e, q, :] for e in range(3) for q in range(2)])
        for n in range(3)], dim=-2)                    # (k, l, z, node, t)
    top = PZ[0, 0] * nodes[:, :, 0] + PZ[1, 0] * nodes[:, :, 1]
    bot = PZ[0, 1] * nodes[:, :, 0] + PZ[1, 1] * nodes[:, :, 1]
    return torch.cat([top, bot], dim=-2)


def _constants():
    """(PHI_ZQ, PHIA, PHIB, W_GAUSS) as 10 doubles and (EDGE_A, EDGE_B) as
    6 int64, in the order the C launcher reads them."""
    vals = [*G.PHI_ZQ.reshape(-1), *G.PHIA, *G.PHIB, *G.W_GAUSS]
    edges = [*G.EDGE_A, *G.EDGE_B]
    return ((ctypes.c_double * 10)(*map(float, vals)),
            (ctypes.c_int64 * 6)(*map(int, edges)))


def lateral_flux(f: torch.Tensor, fext: torch.Tensor, speed: torch.Tensor,
                 edge_len: torch.Tensor) -> torch.Tensor:
    """K4 on the card (shapes in the module docstring)."""
    k, nl, _, nt = f.shape
    cuda_lib.check("f", f, (k, nl, 6, nt), f)
    cuda_lib.check("fext", fext, (k, nl, 3, 2, 2, nt), f)
    cuda_lib.check("speed", speed, (nl, 2, 3, 2, nt), f)
    cuda_lib.check("edge_len", edge_len, (3, nt), f)
    if k * nl * nt == 0:
        raise ValueError(f"lateral_flux: empty input {tuple(f.shape)}")
    out = torch.empty_like(f)
    consts, edges = _constants()
    cuda_lib.launch("lateral_flux", f.dtype, f.device, f.data_ptr(),
                    fext.data_ptr(), speed.data_ptr(), edge_len.data_ptr(),
                    out.data_ptr(), ctypes.cast(consts, ctypes.c_void_p),
                    ctypes.cast(edges, ctypes.c_void_p), k, nl, nt)
    LAUNCHES[("lateral_flux", "cuda")] += 1
    return out
