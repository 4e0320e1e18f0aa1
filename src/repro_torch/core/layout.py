"""SoA <-> cell layout transforms (paper §2.1).

The paper groups 128 prism columns into a *cell* and stores a scalar field as
a (rows = 6*n_layers, cols = 128) matrix per cell, so that 128 threads
solving 128 independent column systems read coalesced addresses.  An array
shaped (n_cells, rows, 128) holds that layout; row = layer*6 + node within a
cell (paper Figure 5: cell -> layer -> node -> column).

These are the plain reshape/permute versions.  The stepper's hot path does
not use them: it keeps the SoA tensors, whose innermost triangle axis is
already the column axis.  `kernels/cell_transpose.py` has the CUDA kernels
(K5, K6) of `soa_to_cell` / `cell_to_soa` for the step boundary.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CELL = 128


def num_cells(nt: int, cell: int = CELL) -> int:
    return (nt + cell - 1) // cell


def pad_nt(x: torch.Tensor, cell: int = CELL) -> torch.Tensor:
    """Zero-pad the minor (triangle/column) axis to a multiple of `cell`."""
    pad = (-x.shape[-1]) % cell
    if pad == 0:
        return x
    return F.pad(x, (0, pad))


def soa_to_cell(x: torch.Tensor, cell: int = CELL) -> torch.Tensor:
    """(..., nl, nodes, nt) -> (..., n_cells, nl*nodes, cell).

    Works for 3D fields (nl, 6, nt) and 2D per-column data (1, 3, nt) alike.
    Pads nt up to a multiple of `cell`."""
    x = pad_nt(x, cell)
    *lead, nl, nn, nt = x.shape
    nc = nt // cell
    x = x.reshape(*lead, nl, nn, nc, cell)
    # -> (..., nc, nl, nn, cell): row = layer*nn + node  (paper Fig. 5)
    x = torch.movedim(x, -2, -4)
    # reshape alone may return a view in SoA order; the cell layout is a
    # memory order, so materialise it
    return x.reshape(*lead, nc, nl * nn, cell).contiguous()


def cell_to_soa(x: torch.Tensor, nl: int, nn: int, nt: int,
                cell: int = CELL) -> torch.Tensor:
    """Inverse of soa_to_cell; slices the padding back off to `nt`."""
    *lead, nc, rows, c = x.shape
    if rows != nl * nn or c != cell:
        raise ValueError(f"cell_to_soa: shape {tuple(x.shape)} is not "
                         f"(..., nc, {nl}*{nn}, {cell})")
    x = x.reshape(*lead, nc, nl, nn, cell)
    x = torch.movedim(x, -4, -2)            # (..., nl, nn, nc, cell)
    x = x.reshape(*lead, nl, nn, nc * cell)
    return x[..., :nt].contiguous()


def blocks_to_cell(blk: torch.Tensor, cell: int = CELL) -> torch.Tensor:
    """Operator blocks (..., nl, 6, 6, nt) -> (..., nc, nl, 6, 6, cell).

    The per-cell operand layout of the paper's column solver (§2.4): each
    cell holds the 6x6 blocks of its 128 columns in the column dimension."""
    blk = pad_nt(blk, cell)
    *lead, nl, a, b, nt = blk.shape
    nc = nt // cell
    blk = blk.reshape(*lead, nl, a, b, nc, cell)
    return torch.movedim(blk, -2, -5).contiguous()


def cell_to_blocks(blk: torch.Tensor, nt: int, cell: int = CELL) -> torch.Tensor:
    """Inverse of blocks_to_cell; slices the padding back off to nt."""
    *lead, nc, nl, a, b, c = blk.shape
    if c != cell:
        raise ValueError(f"cell_to_blocks: last axis {c} is not {cell}")
    blk = torch.movedim(blk, -5, -2).reshape(*lead, nl, a, b, nc * cell)
    return blk[..., :nt].contiguous()


def soa2d_to_cell(x: torch.Tensor, cell: int = CELL) -> torch.Tensor:
    """2D nodal field (..., 3, nt) -> (..., nc, 3, cell)."""
    x = pad_nt(x, cell)
    *lead, nn, nt = x.shape
    nc = nt // cell
    x = x.reshape(*lead, nn, nc, cell)
    return torch.movedim(x, -2, -3).contiguous()


def cell2d_to_soa(x: torch.Tensor, nt: int, cell: int = CELL) -> torch.Tensor:
    *lead, nc, nn, c = x.shape
    x = torch.movedim(x, -3, -2).reshape(*lead, nn, nc * c)
    return x[..., :nt].contiguous()
