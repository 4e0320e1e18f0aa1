"""SoA <-> cell layout transposition (paper §2.1.2): CUDA kernels K5 / K6.

The step-boundary transform: a 3D field (nl, 6, nt) in the stepper's SoA
layout becomes (ceil(nt/128), nl*6, 128) in the cell layout of
`core/layout.py`, zero-padding nt up to the 128-wide cell, and back, slicing
the padding off.  In memory this is a block permutation: row r = layer*6 +
node is cut into 128-wide runs and run c lands at row r of cell c, so a run
is contiguous on both sides.

The kernels (`csrc/ocean_kernels.cu`: soa_to_cell_kernel,
cell_to_soa_kernel) cut the copy into chunks, the 32 * vec elements a warp
moves with one access of `vec` elements per lane, numbered in the order of
the side written, and every thread issues its `per_thread` loads before its
first store.  The launch plan (`launch_plan`) picks the
variant: `vector` (16-byte accesses) when nt is a whole number of 16-byte
vectors and both pointers are 16-byte aligned, else `scalar` (one element
per access); the C launcher refuses any other plan.  The pad lanes of the
last cell are written as zeros by K5 and never read by K6.

`soa_to_cell` / `cell_to_soa` launch the kernels and take only CUDA
tensors of float32 or float64; `soa_to_cell_plain` / `cell_to_soa_plain`
are the plain PyTorch versions (`layout.soa_to_cell` / `cell_to_soa`), used
on CPU tensors and to check the kernels, which must equal them bitwise.
"""
from __future__ import annotations

import functools
import types

import torch

from . import cuda_lib
from ..core import layout
from .dispatch import LAUNCHES

CELL = layout.CELL
WARP = 32
THREADS = 256                 # 8 warps a block (kCopyThreads)
ALIGN = 16                    # bytes of one vector access
# accesses each thread issues before its first store (CopyPlan): 128 B in
# flight per thread in the vector variants, 64 B in the scalar ones
PER_THREAD = {("vector", torch.float32): 8, ("vector", torch.float64): 8,
              ("scalar", torch.float32): 16, ("scalar", torch.float64): 8}
MAX_CHUNKS = 2 ** 32          # the kernels number chunks in 32 bits


def launch_plan(rows: int, nt: int, dtype: torch.dtype, src_ptr: int,
                dst_ptr: int) -> types.MappingProxyType:
    """The kernels' launch for ``rows`` SoA rows of ``nt`` columns between
    the data pointers ``src_ptr`` and ``dst_ptr``: the variant, the
    elements per access (`vec`), the accesses each thread issues before
    storing (`per_thread`), the threads per block and the grid, with the
    chunk width in elements (`chunk`) and the number of chunks (`chunks`),
    as a read-only mapping (plans are cached)."""
    return _plan(rows, nt, dtype, not (src_ptr % ALIGN or dst_ptr % ALIGN))


@functools.lru_cache(maxsize=64)
def _plan(rows: int, nt: int, dtype: torch.dtype,
          aligned: bool) -> types.MappingProxyType:
    if dtype not in cuda_lib.OCEAN_DTYPES:
        raise TypeError(f"cell transpose: {dtype} is not built "
                        "(float32 or float64)")
    if rows < 1 or nt < 1:
        raise ValueError(f"cell transpose: unsupported shape ({rows} rows, "
                         f"{nt} columns)")
    vec = ALIGN // dtype.itemsize
    if nt % vec or not aligned:
        vec = 1
    variant = "vector" if vec > 1 else "scalar"
    per_thread = PER_THREAD[(variant, dtype)]
    chunk = WARP * vec
    chunks = layout.num_cells(nt) * rows * (CELL // chunk)
    per_block = THREADS // WARP * per_thread
    grid = -(-chunks // per_block)
    if grid * per_block >= MAX_CHUNKS:
        raise ValueError(f"cell transpose: {rows} rows x {nt} columns is "
                         f"{chunks} chunks, more than 32-bit chunk numbers take")
    return types.MappingProxyType(dict(
        variant=variant, vec=vec, per_thread=per_thread, threads=THREADS,
        grid=grid, chunk=chunk, chunks=chunks))


def soa_to_cell_plain(x: torch.Tensor) -> torch.Tensor:
    """(nl, 6, nt) -> (ceil(nt/128), nl*6, 128); pads nt up to the cell."""
    return layout.soa_to_cell(x)


def cell_to_soa_plain(x: torch.Tensor, nt: int) -> torch.Tensor:
    """(nc, nl*6, 128) -> (nl, 6, nt)."""
    nc, rows, _ = x.shape
    return layout.cell_to_soa(x, rows // 6, 6, nt)


def _launch(kernel: str, x: torch.Tensor, out: torch.Tensor, rows: int,
            nt: int) -> None:
    plan = launch_plan(rows, nt, x.dtype, x.data_ptr(), out.data_ptr())
    cuda_lib.launch(kernel, x.dtype, x.device, x.data_ptr(), out.data_ptr(),
                    rows, nt, plan["vec"], plan["per_thread"],
                    plan["threads"], plan["grid"])
    LAUNCHES[(kernel, "cuda")] += 1


def soa_to_cell(x: torch.Tensor) -> torch.Tensor:
    """K5 on the card: (nl, 6, nt) -> (ceil(nt/128), nl*6, 128)."""
    if x.dim() != 3 or x.shape[1] != 6:
        raise ValueError(f"soa_to_cell: expected (nl, 6, nt), got {tuple(x.shape)}")
    nl, _, nt = x.shape
    cuda_lib.check("x", x, (nl, 6, nt), x)
    out = torch.empty((layout.num_cells(nt), nl * 6, CELL), dtype=x.dtype,
                      device=x.device)
    _launch("soa_to_cell", x, out, nl * 6, nt)
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
    out = torch.empty((rows // 6, 6, nt), dtype=x.dtype, device=x.device)
    _launch("cell_to_soa", x, out, rows, nt)
    return out
