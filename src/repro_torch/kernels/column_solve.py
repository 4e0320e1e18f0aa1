"""Block-tridiagonal (6x6 blocks) column solver: CUDA kernel K3.

Paper §2.4: the vertically-implicit momentum/tracer systems couple each
prism's 6 nodes to the prisms above and below.  The block-Thomas recurrence

    S_l = D_l - L_l C_{l-1};  C_l = S_l^{-1} U_l;  y_l = S_l^{-1}(b_l - L_l y_{l-1})
    x_{nl-1} = y_{nl-1};      x_l = y_l - C_l x_{l+1}

runs with an unpivoted Gauss-Jordan elimination of each 6x6 block (the
operators are diagonally dominant mass + dissipation blocks).  The kernel
(`csrc/ocean_kernels.cu`: block_thomas_kernel) solves a tile of `tc`
consecutive columns in a block of 6 * tc threads, one thread per (row,
column), and keeps [C_l | y_l] of every layer in the tile's shared memory
(variant `onchip`), so it moves only the blocks, the right-hand sides and
the solution.  Columns too deep for shared memory take the same kernel
with [C_l | y_l] in a global scratch that the wrapper allocates (variant
`global`).  `launch_plan` picks the variant, the tile width, the shared
bytes and the grid from (nl, k, nt, dtype) before the launch; the C
launcher refuses any plan it did not build.

Shapes (the stepper's own `vertical.Blocks` layout, nt innermost):
  lo, dg, up  (nl, 6, 6, nt)   lo[0] and up[nl-1] are ignored
  rhs, x      (k, nl, 6, nt)   k right-hand sides: the kernel is built for
                               k in RHS_WIDTHS (the step solves k = 2)

`block_thomas` launches the kernel and takes only CUDA tensors;
`block_thomas_plain` is the plain PyTorch version of the same elimination,
vectorised over the columns.
"""
from __future__ import annotations

import ctypes
import functools
import types

import torch

from . import cuda_lib
from .dispatch import LAUNCHES

RHS_WIDTHS = (2, 4)   # the kernel's instantiations in csrc/ocean_kernels.cu
TILE_COLS = (32, 16, 8)   # columns per tile, widest first
# the widest tile of each dtype, the only one of its global variant (the
# instantiations kThomasWidest selects in csrc/ocean_kernels.cu)
PREFERRED_TC = {torch.float32: 32, torch.float64: 16}
MAX_SMEM = 232_448    # shared memory a block can use (H100)
MAX_GRID = 2 ** 31 - 1


def _tile(nl: int, k: int, nt: int, dtype: torch.dtype, tc: int,
          variant: str) -> types.MappingProxyType:
    """``variant`` ("onchip" or "global") with tiles of ``tc`` columns:
    threads, shared bytes, grid and the global scratch's elements (0 on
    chip).  Shared memory holds [C_l | y_l] of every layer on chip, nl * 6
    * (6 + k) * tc values, and one layer's slot in the global variant,
    where the rows of S_l and of the right-hand side are exchanged."""
    width = 6 * (6 + k)
    rows = (nl if variant == "onchip" else 1) * width
    grid = -(-nt // tc)
    if grid > MAX_GRID:
        raise ValueError(f"block_thomas: {nt} columns need {grid} tiles, "
                         f"more than a grid holds")
    return types.MappingProxyType(dict(
        variant=variant, tc=tc, threads=6 * tc,
        smem=rows * tc * dtype.itemsize, grid=grid,
        scratch=0 if variant == "onchip" else grid * nl * width * tc))


@functools.lru_cache(maxsize=64)
def launch_plan(nl: int, k: int, nt: int, dtype: torch.dtype,
                smem_limit: int = MAX_SMEM) -> types.MappingProxyType:
    """K3's launch for nl layers, k right-hand sides and nt columns: the
    widest tile, from PREFERRED_TC[dtype] down through TILE_COLS, whose
    shared memory fits ``smem_limit``, on chip; where no tile width fits,
    the global variant at PREFERRED_TC[dtype].  Read only (plans are
    cached).  ``smem_limit`` lets a caller force the global variant at a
    shallow depth.

    The preferred widths are what an H100 showed at the step's shape (16
    layers, k = 2; PERF.md): float32 runs fastest at 32 columns, two tiles
    a SM, a warp a row; float64 at 16 columns, where two tiles a SM fit
    and a warp's two rows read each shared value as one broadcast, ahead
    of 32 columns at one tile a SM.  Narrower tiles, half-empty warps,
    come last."""
    if dtype not in cuda_lib.OCEAN_DTYPES:
        raise TypeError(f"block_thomas: {dtype} is not built (float32 or float64)")
    if k not in RHS_WIDTHS or nl < 1 or nt < 1:
        raise ValueError(f"block_thomas: unsupported shape (k={k}, nl={nl}, "
                         f"nt={nt}; k in {RHS_WIDTHS}, nl, nt >= 1)")
    widest = PREFERRED_TC[dtype]
    for tc in TILE_COLS:
        if tc <= widest:
            plan = _tile(nl, k, nt, dtype, tc, "onchip")
            if plan["smem"] <= smem_limit:
                return plan
    plan = _tile(nl, k, nt, dtype, widest, "global")
    if plan["smem"] > smem_limit:
        raise ValueError(f"block_thomas: no tile fits {smem_limit} bytes of "
                         f"shared memory")
    return plan


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


def _checked(lo, dg, up, rhs) -> tuple:
    k, nl, _, nt = rhs.shape
    for name, t in (("lo", lo), ("dg", dg), ("up", up)):
        cuda_lib.check(name, t, (nl, 6, 6, nt), rhs)
    cuda_lib.check("rhs", rhs, (k, nl, 6, nt), rhs)
    if k not in RHS_WIDTHS or nl * nt == 0:
        raise ValueError(f"block_thomas: unsupported rhs shape {tuple(rhs.shape)}"
                         f" (k in {RHS_WIDTHS}, nl, nt >= 1)")
    return nl, k, nt, rhs.dtype


def block_thomas(lo: torch.Tensor, dg: torch.Tensor, up: torch.Tensor,
                 rhs: torch.Tensor, smem_limit: int = MAX_SMEM) -> torch.Tensor:
    """K3 on the card: solve the block-tridiagonal systems, rhs (k, nl, 6, nt),
    through `launch_plan` (``smem_limit`` bounds the tile's shared memory)."""
    plan = launch_plan(*_checked(lo, dg, up, rhs), smem_limit)
    x = torch.empty_like(rhs)
    scratch = (torch.empty(plan["scratch"], dtype=rhs.dtype, device=rhs.device)
               if plan["variant"] == "global" else None)
    k, nl, _, nt = rhs.shape
    cuda_lib.launch("block_thomas", rhs.dtype, rhs.device, lo.data_ptr(),
                    dg.data_ptr(), up.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), k, nl, nt,
                    int(plan["variant"] == "onchip"), plan["tc"],
                    plan["threads"], plan["smem"], plan["grid"])
    LAUNCHES[("block_thomas", "cuda")] += 1
    return x


def tiles_per_sm(plan, k: int, dtype: torch.dtype) -> int:
    """Tiles of ``plan`` that one SM of the current card holds at once, by
    the CUDA occupancy calculator."""
    tiles = ctypes.c_int64()
    cuda_lib.call("block_thomas_occupancy", dtype, k,
                  int(plan["variant"] == "onchip"), plan["tc"], plan["smem"],
                  ctypes.byref(tiles))
    return tiles.value
