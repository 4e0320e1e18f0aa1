"""Batched scalar tridiagonal (Thomas) solve per column: CUDA kernel K7.

Paper §2.4: the GLS turbulence closure has one unknown per prism, so one
tridiagonal system per column; the step solves four, two in each stage
(`core/turbulence.py: gls_step`, through `ops.tridiag`).  The kernel
(`csrc/ocean_kernels.cu`: tridiag_kernel) runs one thread per column over
the nl layers in `thomas_solve`'s order, op for op, so it equals the plain
version bitwise, and loads the operands of a window of layers ahead of the
recurrence.  Two variants:

  * ``onchip``: cp and dp of every layer in shared memory, 2 nl values a
                column, so only dl, d, du, b and x touch device memory;
  * ``global``: cp in a global scratch (nl, C) that the wrapper allocates
                and dp in x, both read back: 9 values a layer and column
                move instead of 5, but the block needs no shared memory.

`launch_plan` picks the variant, the shared bytes and the grid from (nl, C,
dtype) before the launch: ``onchip`` while enough of its blocks fit an SM
to keep the loads in flight (MIN_BLOCKS), else ``global``; the C launcher
refuses any plan it did not build.

Shapes: dl, d, du, b and x are (nl, C), layer first, columns innermost;
dl[0] and du[nl-1] multiply a zero carry.  Any C is taken (the TPU version
needs C % 128 == 0), and so are pointers at any element offset.

`tridiag` launches the kernel and takes only CUDA tensors; `tridiag_plain`
is the plain PyTorch version, the port's `turbulence.thomas_solve`, used on
CPU tensors and to check the kernel.
"""
from __future__ import annotations

import functools
import types

import torch

from . import cuda_lib
from ..core import turbulence
from .dispatch import LAUNCHES

THREADS = 128             # columns a block (kTriThreads)
MAX_SMEM = 232_448        # shared memory a block can use (H100)
SM_SMEM = 233_472         # shared memory of an SM, 1,024 bytes of it a block's (H100)
# the fewest onchip blocks a SM at which the onchip variant ran faster than
# the global one on an H100 at 160,000 columns (PERF.md, K7): the plan takes
# onchip up to 56 layers in float32 and 37 in float64
MIN_BLOCKS = {torch.float32: 4, torch.float64: 3}
MAX_GRID = 2 ** 31 - 1
# the plan's entries the C launcher takes after its onchip flag, in its order
LAUNCH_KEYS = ("threads", "smem", "grid")


def _plan(variant: str, nl: int, C: int,
          dtype: torch.dtype) -> types.MappingProxyType:
    """``variant`` for nl layers over C columns: the shared bytes (onchip:
    cp and dp of every layer and column of a block), the grid and the global
    scratch's elements (global)."""
    onchip = variant == "onchip"
    return types.MappingProxyType(dict(
        variant=variant, threads=THREADS,
        smem=2 * nl * THREADS * dtype.itemsize if onchip else 0,
        grid=-(-C // THREADS), scratch=0 if onchip else nl * C))


def blocks_per_sm(plan) -> int:
    """Blocks of ``plan`` that the shared memory of one SM holds."""
    return SM_SMEM // (plan["smem"] + 1024)


@functools.lru_cache(maxsize=256)
def alternatives(nl: int, C: int, dtype: torch.dtype) -> tuple:
    """Every plan the launcher takes for nl layers over C columns, the
    plan's own first: ``onchip`` where its shared bytes fit MAX_SMEM and at
    least MIN_BLOCKS[dtype] of its blocks fit an SM, else ``global``, then
    the other where the launcher takes it.  Read only (plans are cached)."""
    if dtype not in cuda_lib.OCEAN_DTYPES:
        raise TypeError(f"tridiag: {dtype} is not built (float32 or float64)")
    if nl < 1 or C < 1:
        raise ValueError(f"tridiag: empty system ({nl}, {C}) (nl, C >= 1)")
    if -(-C // THREADS) > MAX_GRID:
        raise ValueError(f"tridiag: {C} columns need more blocks than a grid holds")
    onchip, glob = _plan("onchip", nl, C, dtype), _plan("global", nl, C, dtype)
    if onchip["smem"] > MAX_SMEM:
        return (glob,)
    if blocks_per_sm(onchip) >= MIN_BLOCKS[dtype]:
        return onchip, glob
    return glob, onchip


def launch_plan(nl: int, C: int, dtype: torch.dtype) -> types.MappingProxyType:
    """K7's launch for nl layers over C columns: the first of
    `alternatives`."""
    return alternatives(nl, C, dtype)[0]


def tridiag_plain(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Thomas solve of (nl, C) systems in plain PyTorch."""
    return turbulence.thomas_solve(dl, d, du, b)


def tridiag(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
            b: torch.Tensor, plan=None) -> torch.Tensor:
    """K7 on the card: solve the (nl, C) tridiagonal systems.  ``plan``
    overrides `launch_plan`'s choice (a plan of `alternatives`, for testing
    and timing them); the launcher refuses a plan it did not build."""
    if d.dim() != 2:
        raise ValueError(f"tridiag: expected (nl, C) operands, got {tuple(d.shape)}")
    nl, C = d.shape
    for name, t in (("dl", dl), ("d", d), ("du", du), ("b", b)):
        cuda_lib.check(name, t, (nl, C), d)
    if plan is None:
        plan = launch_plan(nl, C, d.dtype)
    x = torch.empty_like(d)
    cp = (torch.empty(plan["scratch"], dtype=d.dtype, device=d.device)
          if plan["variant"] == "global" else None)
    cuda_lib.launch("tridiag", d.dtype, d.device, dl.data_ptr(), d.data_ptr(),
                    du.data_ptr(), b.data_ptr(), x.data_ptr(),
                    None if cp is None else cp.data_ptr(), nl, C,
                    int(plan["variant"] == "onchip"),
                    *(plan[key] for key in LAUNCH_KEYS))
    LAUNCHES[("tridiag", "cuda")] += 1
    return x
