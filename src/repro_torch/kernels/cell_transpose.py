"""SoA <-> cell layout transposition (paper §2.1.2): CUDA kernels K5 / K6.

The step-boundary transform: a 3D field (nl, 6, nt) in the stepper's SoA
layout becomes (ceil(nt/128), nl*6, 128) in the cell layout of
`core/layout.py`, zero-padding nt up to the 128-wide cell, and back, slicing
the padding off.  In memory this is a block permutation: row r = layer*6 +
node is cut into 128-wide segments and segment c lands at row r of cell c.
The kernels (`csrc/ocean_kernels.cu`: soa_to_cell_kernel,
cell_to_soa_kernel) copy one 128-element run per thread row, so both sides
are read and written at neighbouring addresses, and mask the pad lanes
instead of padding first.

`soa_to_cell` / `cell_to_soa` launch the kernels and take only CUDA
tensors of float32 or float64; `soa_to_cell_plain` / `cell_to_soa_plain`
are the plain PyTorch versions (`layout.soa_to_cell` / `cell_to_soa`), used
on CPU tensors and to check the kernels, which must equal them bitwise.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from ..core import layout
from .dispatch import LAUNCHES

CELL = layout.CELL
MAX_ROWS = 4 * 65535          # the launch grid's y extent is rows / 4


def soa_to_cell_plain(x: torch.Tensor) -> torch.Tensor:
    """(nl, 6, nt) -> (ceil(nt/128), nl*6, 128); pads nt up to the cell."""
    return layout.soa_to_cell(x)


def cell_to_soa_plain(x: torch.Tensor, nt: int) -> torch.Tensor:
    """(nc, nl*6, 128) -> (nl, 6, nt)."""
    nc, rows, _ = x.shape
    return layout.cell_to_soa(x, rows // 6, 6, nt)


def _check_rows(name: str, rows: int, n: int) -> None:
    if rows == 0 or n == 0 or rows > MAX_ROWS:
        raise ValueError(f"{name}: unsupported shape ({rows} rows, {n} "
                         f"columns; 1 <= rows <= {MAX_ROWS})")


def soa_to_cell(x: torch.Tensor) -> torch.Tensor:
    """K5 on the card: (nl, 6, nt) -> (ceil(nt/128), nl*6, 128)."""
    if x.dim() != 3 or x.shape[1] != 6:
        raise ValueError(f"soa_to_cell: expected (nl, 6, nt), got {tuple(x.shape)}")
    nl, _, nt = x.shape
    cuda_lib.check("x", x, (nl, 6, nt), x)
    _check_rows("soa_to_cell", nl * 6, nt)
    out = torch.empty((layout.num_cells(nt), nl * 6, CELL), dtype=x.dtype,
                      device=x.device)
    cuda_lib.launch("soa_to_cell", x.dtype, x.device, x.data_ptr(),
                    out.data_ptr(), nl * 6, nt)
    LAUNCHES[("soa_to_cell", "cuda")] += 1
    return out


def cell_to_soa(x: torch.Tensor, nt: int) -> torch.Tensor:
    """K6 on the card: (nc, nl*6, 128) -> (nl, 6, nt), nt <= nc*128."""
    if x.dim() != 3 or x.shape[1] % 6 or x.shape[2] != CELL:
        raise ValueError(f"cell_to_soa: expected (nc, nl*6, {CELL}), "
                         f"got {tuple(x.shape)}")
    nc, rows, _ = x.shape
    cuda_lib.check("x", x, (nc, rows, CELL), x)
    if not (nc - 1) * CELL < nt <= nc * CELL:
        raise ValueError(f"cell_to_soa: nt={nt} does not fit {nc} cells")
    _check_rows("cell_to_soa", rows, nt)
    out = torch.empty((rows // 6, 6, nt), dtype=x.dtype, device=x.device)
    cuda_lib.launch("cell_to_soa", x.dtype, x.device, x.data_ptr(),
                    out.data_ptr(), rows, nt)
    LAUNCHES[("cell_to_soa", "cuda")] += 1
    return out
