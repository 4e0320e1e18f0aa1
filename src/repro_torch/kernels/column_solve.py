"""Block-tridiagonal (6x6 blocks) column solver: CUDA kernel K3.

Paper §2.4: the vertically-implicit momentum/tracer systems couple each
prism's 6 nodes to the prisms above and below.  The block-Thomas recurrence

    S_l = D_l - L_l C_{l-1};  C_l = S_l^{-1} U_l;  y_l = S_l^{-1}(b_l - L_l y_{l-1})
    x_{nl-1} = y_{nl-1};      x_l = y_l - C_l x_{l+1}

runs one CUDA thread per column (`csrc/ocean_kernels.cu`:
block_thomas_kernel), as SLIM does, with an unpivoted Gauss-Jordan
elimination of each 6x6 block in registers (the operators are diagonally
dominant mass + dissipation blocks).  C_l goes to a global scratch
(nl, 6, 6, nt) that the wrapper allocates, for the backward sweep.

Shapes (the stepper's own `vertical.Blocks` layout, nt innermost):
  lo, dg, up  (nl, 6, 6, nt)   lo[0] and up[nl-1] are ignored
  rhs, x      (k, nl, 6, nt)   k right-hand sides: the kernel is built for
                               k in RHS_WIDTHS (the step solves k = 2)

`block_thomas` launches the kernel and takes only CUDA tensors;
`block_thomas_plain` is the plain PyTorch version of the same elimination,
vectorised over the columns.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .dispatch import LAUNCHES

RHS_WIDTHS = (2, 4)   # the kernel's instantiations in csrc/ocean_kernels.cu


def _bmm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-column (6, 6, nt) @ (6, m, nt)."""
    return (A[:, :, None, :] * B[None]).sum(dim=1)


def block_thomas_plain(lo: torch.Tensor, dg: torch.Tensor, up: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same unpivoted elimination,
    one layer at a time, every entry a (nt,) vector."""
    k, nl, _, nt = rhs.shape
    C = torch.zeros((6, 6, nt), dtype=rhs.dtype, device=rhs.device)
    y = torch.zeros((6, k, nt), dtype=rhs.dtype, device=rhs.device)
    Cs, ys = [], []
    for l in range(nl):
        L = lo[l]
        S = dg[l] - _bmm(L, C)
        R = torch.cat([up[l], rhs[:, l].transpose(0, 1) - _bmm(L, y)], dim=1)
        for col in range(6):
            inv = 1.0 / S[col, col]
            Srow = S[col] * inv
            Rrow = R[col] * inv
            S[col] = Srow
            R[col] = Rrow
            for r in range(6):
                if r != col:
                    f = S[r, col].clone()
                    S[r] -= f * Srow
                    R[r] -= f * Rrow
        C, y = R[:, :6], R[:, 6:]
        Cs.append(C)
        ys.append(y)
    x = ys[-1]
    xs = [x]
    for l in range(nl - 2, -1, -1):
        x = ys[l] - _bmm(Cs[l], x)
        xs.append(x)
    return torch.stack(xs[::-1], dim=1).transpose(0, 2).contiguous()


def block_thomas(lo: torch.Tensor, dg: torch.Tensor, up: torch.Tensor,
                 rhs: torch.Tensor) -> torch.Tensor:
    """K3 on the card: solve the block-tridiagonal systems, rhs (k, nl, 6, nt)."""
    k, nl, _, nt = rhs.shape
    for name, t in (("lo", lo), ("dg", dg), ("up", up)):
        cuda_lib.check(name, t, (nl, 6, 6, nt), rhs)
    cuda_lib.check("rhs", rhs, (k, nl, 6, nt), rhs)
    if k not in RHS_WIDTHS or nl * nt == 0:
        raise ValueError(f"block_thomas: unsupported rhs shape {tuple(rhs.shape)}"
                         f" (k in {RHS_WIDTHS}, nl, nt >= 1)")
    x = torch.empty_like(rhs)
    scratch = torch.empty_like(dg)
    cuda_lib.launch("block_thomas", rhs.dtype, rhs.device, lo.data_ptr(),
                    dg.data_ptr(), up.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                    scratch.data_ptr(), k, nl, nt)
    LAUNCHES[("block_thomas", "cuda")] += 1
    return x
