"""Batched scalar tridiagonal (Thomas) solve per column: CUDA kernel K7.

Paper §2.4: the GLS turbulence closure has one unknown per prism, so one
tridiagonal system per column.  The kernel (`csrc/ocean_kernels.cu`:
tridiag_kernel) runs one thread per column over the nl layers, with the
forward coefficients cp in a global scratch laid out like the operands, so
every access is coalesced.

Shapes: dl, d, du, b and x are (nl, C), layer first, columns innermost;
dl[0] and du[nl-1] are ignored.  Any C is taken (the TPU version needs
C % 128 == 0).

`tridiag` launches the kernel and takes only CUDA tensors; `tridiag_plain`
is the plain PyTorch version, the port's `turbulence.thomas_solve`, used on
CPU tensors and to check the kernel.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from ..core.turbulence import thomas_solve
from .dispatch import LAUNCHES


def tridiag_plain(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Thomas solve of (nl, C) systems in plain PyTorch."""
    return thomas_solve(dl, d, du, b)


def tridiag(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """K7 on the card: solve the (nl, C) tridiagonal systems."""
    if d.dim() != 2:
        raise ValueError(f"tridiag: expected (nl, C) operands, got {tuple(d.shape)}")
    nl, C = d.shape
    for name, t in (("dl", dl), ("d", d), ("du", du), ("b", b)):
        cuda_lib.check(name, t, (nl, C), d)
    if nl < 1 or C < 1:
        raise ValueError(f"tridiag: empty system {tuple(d.shape)} (nl, C >= 1)")
    x = torch.empty_like(d)
    cp = torch.empty_like(d)
    cuda_lib.launch("tridiag", d.dtype, d.device, dl.data_ptr(), d.data_ptr(),
                    du.data_ptr(), b.data_ptr(), x.data_ptr(), cp.data_ptr(),
                    nl, C)
    LAUNCHES[("tridiag", "cuda")] += 1
    return x
