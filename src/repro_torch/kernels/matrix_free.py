"""Matrix-free column solvers for r and w (paper Alg. 1): CUDA kernels K1/K2.

The D_vu / D_vd systems reduce to a single sweep per column after applying
M_h^{-1} x = (12/A)(x - sum(x)/4) per face (see core/vertical.py).  The
kernels (`csrc/ocean_kernels.cu`: solve_r_kernel, solve_w_kernel) run one
thread per (component, triangle) with the 3-value carry in registers.

Shapes (SoA, as the stepper holds them):
  F       (K, nl, 6, nt)   assembled RHS, K components
  area    (nt,)            triangle areas (shared by the K components)
  bc      (K, 3, nt)       r_surf (top-down) / w_floor (bottom-up)
  out     (K, nl, 6, nt)

`solve_r` / `solve_w` launch the kernels and take only CUDA tensors;
`solve_r_plain` / `solve_w_plain` are the plain PyTorch versions of the
same functions (cumsum form), used on CPU tensors and to check the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .dispatch import LAUNCHES


def _minv(face: torch.Tensor, inva: torch.Tensor) -> torch.Tensor:
    return inva * (face - 0.25 * face.sum(dim=-2, keepdim=True))


def _faces(F: torch.Tensor, area: torch.Tensor):
    inva = 12.0 / area
    return _minv(F[..., 0:3, :], inva), _minv(F[..., 3:6, :], inva)


def solve_r_plain(F: torch.Tensor, area: torch.Tensor,
                  r_surf: torch.Tensor) -> torch.Tensor:
    """Top-down sweep: r_b^l = r_surf - sum_{k<=l}(g_t + g_b), r_t = r_b + 2 g_b."""
    gt, gb = _faces(F, area)
    rb = r_surf[..., None, :, :] - torch.cumsum(gt + gb, dim=-3)
    return torch.cat([rb + 2.0 * gb, rb], dim=-2)


def solve_w_plain(F: torch.Tensor, area: torch.Tensor,
                  w_floor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bottom-up sweep: w_t^l = w_floor + sum_{k>=l}(g_t + g_b), w_b = w_t - 2 g_t."""
    gt, gb = _faces(F, area)
    wt = torch.flip(torch.cumsum(torch.flip(gt + gb, [-3]), dim=-3), [-3])
    if w_floor is not None:
        wt = w_floor[..., None, :, :] + wt
    return torch.cat([wt, wt - 2.0 * gt], dim=-2)


def _sweep(kernel: str, F, area, bc):
    K, nl, _, nt = F.shape
    cuda_lib.check("F", F, (K, nl, 6, nt), F)
    cuda_lib.check("area", area, (nt,), F)
    if bc is not None:
        cuda_lib.check("bc", bc, (K, 3, nt), F)
    if K * nl * nt == 0:
        raise ValueError(f"{kernel}: empty input {tuple(F.shape)}")
    out = torch.empty_like(F)
    cuda_lib.launch(kernel, F.dtype, F.device, F.data_ptr(), area.data_ptr(),
                    None if bc is None else bc.data_ptr(), out.data_ptr(),
                    K, nl, nt)
    LAUNCHES[(kernel, "cuda")] += 1
    return out


def solve_r(F: torch.Tensor, area: torch.Tensor,
            r_surf: torch.Tensor) -> torch.Tensor:
    """K1 on the card: F (K, nl, 6, nt), area (nt,), r_surf (K, 3, nt)."""
    return _sweep("solve_r", F, area, r_surf)


def solve_w(F: torch.Tensor, area: torch.Tensor,
            w_floor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 on the card; ``w_floor=None`` seeds the sweep with zeros inside
    the kernel (impermeable floor)."""
    return _sweep("solve_w", F, area, w_floor)
